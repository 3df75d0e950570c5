"""Activation-sharding context for the LM stack (port of ``repro/models/sharding_ctx.py``).

The JAX package pins activations to batch-over-(pod, data) at block
boundaries so that GSPMD does not put the data axis on a feature dimension.
Here a launcher installs a named ``DeviceMesh`` with ``set_mesh`` or
``use_mesh``; ``constrain_batch`` / ``constrain`` then ``redistribute`` a
``DTensor`` to that layout.  A plain tensor is one rank's local shard and
passes unchanged, and with no mesh installed (one card, the tests) every
function returns its input, as in the JAX package.

The installed mesh is process-wide state, as the JAX package's is:
``use_mesh`` restores the previous one on exit.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.params import mesh_shape, placements

_MESH = None
_SEQ_PARALLEL = False  # shard dim 1 (sequence) of 3D activations over 'model'


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def set_seq_parallel(on: bool) -> None:
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = on


@contextmanager
def use_mesh(mesh, seq_parallel: bool = False):
    global _MESH, _SEQ_PARALLEL
    prev, prev_sp = _MESH, _SEQ_PARALLEL
    _MESH, _SEQ_PARALLEL = mesh, seq_parallel
    try:
        yield
    finally:
        _MESH, _SEQ_PARALLEL = prev, prev_sp


def _batch_axes(shape) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in shape)


def _batch_part(shape, n: int):
    """The spec entry of a batch of ``n``: the data-parallel axes where they
    divide it, else None (replicated)."""
    axes = _batch_axes(shape)
    if not axes or n % math.prod(shape[a] for a in axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def _redistribute(x: torch.Tensor, spec) -> torch.Tensor:
    if not isinstance(x, DTensor):
        return x  # a rank's local shard: its layout is the caller's
    return x.redistribute(_MESH, placements(spec, _MESH))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to the data-parallel axes (divisibility-checked: a batch
    they do not divide is replicated).  With sequence parallelism on, dim 1
    of 3D activations is also pinned to the model axis.  The identity
    without an installed mesh."""
    if _MESH is None:
        return x
    shape = mesh_shape(_MESH)
    if not _batch_axes(shape):
        return x
    rest = [None] * (x.ndim - 1)
    if _SEQ_PARALLEL and x.ndim == 3 and "model" in shape and x.shape[1] % shape["model"] == 0:
        rest[0] = "model"
    return _redistribute(x, (_batch_part(shape, x.shape[0]), *rest))


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """``x`` with dim 0 over the data-parallel axes (where they divide it)
    and every other dimension whole.  The identity without an installed
    mesh."""
    if _MESH is None:
        return x
    return _redistribute(x, (_batch_part(mesh_shape(_MESH), x.shape[0]), *[None] * (x.ndim - 1)))


def constrain(x: torch.Tensor, *spec_parts) -> torch.Tensor:
    if _MESH is None:
        return x
    return _redistribute(x, spec_parts)


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` reshaped with dimension ``dim`` split into ``sizes`` (heads and
    their width, or KV heads and their query groups).  DTensor cannot split a
    shard unevenly, so a DTensor sharded on ``dim`` over a mesh dimension that
    does not divide ``sizes[0]`` (8 KV heads on a 16-wide model axis) is first
    replicated over that mesh dimension.  A plain tensor is only reshaped."""
    d = dim % x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        keep = [Replicate() if p.is_shard(d) and sizes[0] % mesh.size(i) else p for i, p in enumerate(x.placements)]
        if keep != list(x.placements):
            x = x.redistribute(mesh, keep)
    return x.reshape(*x.shape[:d], *sizes, *x.shape[d + 1 :])


def merge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimensions ``dim`` and ``dim + 1`` merged into one (heads
    and their width).  A plain tensor is only reshaped.  A DTensor's backward
    splits the gradient with ``unflatten``: DTensor's own view backward
    cannot split a gradient sharded over a mesh dimension that does not
    divide the heads (56 heads on a 16-wide model axis)."""
    d = dim % x.ndim
    if isinstance(x, DTensor):
        return _Merge.apply(x, d)
    return x.reshape(*x.shape[:d], x.shape[d] * x.shape[d + 1], *x.shape[d + 2 :])


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d):
        ctx.d, ctx.sizes = d, (x.shape[d], x.shape[d + 1])
        return x.reshape(*x.shape[:d], x.shape[d] * x.shape[d + 1], *x.shape[d + 2 :])

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.d, ctx.sizes), None


def constrain_heads(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``x`` (B, S, H, D) with dim 0 over the data-parallel axes (where they
    divide it) and its heads over ``model`` where ``groups`` (the KV heads
    the heads are split into) divide over it, every other dimension whole:
    the layout attention runs in.  A partial sum is reduced.  The identity
    without an installed mesh."""
    if _MESH is None:
        return x
    shape = mesh_shape(_MESH)
    heads = "model" if "model" in shape and groups % shape["model"] == 0 else None
    return _redistribute(x, (_batch_part(shape, x.shape[0]), None, heads, None))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` laid out as ``ref`` (a partial sum reduced into its
    placements); a plain tensor as it is."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of two operands.  On DTensors each rank
    contracts its own shards (``_LocalEinsum``): a mesh dimension stays
    sharded where it shards a batch label of ``eq`` (one in both operands and
    the output) in both operands alike, and is replicated otherwise (DTensor
    gathers or reduces it first).  DTensor's own einsum flattens the batch labels into one
    dimension, which it cannot do when the second of them is sharded (torch
    2.11) and whose strided layout stalls its planner on a three-axis mesh.
    Plain tensors go to ``torch.einsum`` as they are."""
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim) for t in (a, b))
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    labels = []
    for pa, pb in zip(a.placements, b.placements):
        keep = pa.is_shard() and pb.is_shard() and la[pa.dim] == lb[pb.dim] and la[pa.dim] in out
        labels.append(la[pa.dim] if keep else None)

    def layout(spec):
        return [Shard(spec.index(l)) if l else Replicate() for l in labels]

    a, b = a.redistribute(mesh, layout(la)), b.redistribute(mesh, layout(lb))
    return _LocalEinsum.apply(eq, a, b, layout(out))


class _LocalEinsum(torch.autograd.Function):
    """``einsum``'s shard-local contraction.  Its backward is the two
    contractions of the gradient, each rank on its shards, made contiguous:
    DTensor runs its views on a gradient's local tensor as ``view``."""

    @staticmethod
    def forward(ctx, eq, a, b, placements):
        ctx.eq, ctx.placements = eq, placements
        ctx.save_for_backward(a, b)
        return DTensor.from_local(torch.einsum(eq, a.to_local(), b.to_local()), a.device_mesh, placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (la, lb), lo = ctx.eq.split("->")[0].split(","), ctx.eq.split("->")[1]
        gl = g.redistribute(a.device_mesh, ctx.placements).to_local()
        ga = torch.einsum(f"{lo},{lb}->{la}", gl, b.to_local()).contiguous()
        gb = torch.einsum(f"{lo},{la}->{lb}", gl, a.to_local()).contiguous()
        return (None, DTensor.from_local(ga, a.device_mesh, a.placements, run_check=False),
                DTensor.from_local(gb, b.device_mesh, b.placements, run_check=False), None)
