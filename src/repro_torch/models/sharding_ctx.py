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


def _redistribute(x: torch.Tensor, spec) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x  # a rank's local shard: its layout is the caller's
    return x.redistribute(_MESH, placements(spec, _MESH))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to the data-parallel axes (divisibility-checked).  With
    sequence parallelism on, dim 1 of 3D activations is also pinned to the
    model axis.  The identity without an installed mesh."""
    if _MESH is None:
        return x
    shape = mesh_shape(_MESH)
    axes = _batch_axes(shape)
    if not axes:
        return x
    if x.shape[0] % math.prod(shape[a] for a in axes) != 0:
        return x
    rest = [None] * (x.ndim - 1)
    if _SEQ_PARALLEL and x.ndim == 3 and "model" in shape and x.shape[1] % shape["model"] == 0:
        rest[0] = "model"
    return _redistribute(x, (axes if len(axes) > 1 else axes[0], *rest))


def constrain(x: torch.Tensor, *spec_parts) -> torch.Tensor:
    if _MESH is None:
        return x
    return _redistribute(x, spec_parts)
