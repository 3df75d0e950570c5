"""Parameter declarations for the LM stack (port of ``repro/models/params.py``).

A model definition builds a tree (nested dicts and lists) of ``ParamDef``
leaves.  From that one tree come the parameter count and bytes,
``materialize`` makes the tensors, and the sharding rules read each leaf's
logical axes:

* ``spec_for(d, rules, mesh)`` / ``specs`` -- a ``PartitionSpec``-like tuple
  per leaf, one entry per dimension: None, a mesh axis name, or a tuple of
  them.  ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with
  named dimensions or any mapping of axis name to size, so the rules resolve
  against a 512-device shape without devices.
* ``shardings`` -- per leaf a ``NamedSharding``: the DeviceMesh and the
  DTensor placements of that spec (``Shard(dim)`` on each mesh dimension
  named for tensor dimension ``dim``, ``Replicate()`` elsewhere).

Logical axis names used by the LM stack (the JAX package's):
  "embed"   model width dim          -> FSDP-sharded over the data axis
  "ff"      feed-forward hidden      -> tensor-parallel over the model axis
  "heads"   flattened head*head_dim  -> tensor-parallel over the model axis
  "kv"      flattened kv*head_dim    -> tensor-parallel over the model axis
  "vocab"   vocabulary               -> tensor-parallel over the model axis
  "experts" MoE expert count         -> expert-parallel over the model axis
  "layers"  stacked layer dim        -> never sharded
  None      replicated
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import torch

from repro_torch import nn


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for "normal" (fan-in scaled)
    dtype: torch.dtype = torch.bfloat16
    # sharding granularity per dim: a mesh axis may shard dim d only if
    # (shape[d] / granularity[d]) % axis_size == 0 (head dims: head_dim, so a
    # shard never cuts a head)
    granularity: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef: shape {self.shape} and axes {self.axes} differ in rank")
        if self.granularity is not None and len(self.granularity) != len(self.shape):
            raise ValueError(f"ParamDef: granularity {self.granularity} does not match shape {self.shape}")

    def gran(self, i: int) -> int:
        return 1 if self.granularity is None else self.granularity[i]


def pdef(shape, axes, init="normal", scale=1.0, dtype=torch.bfloat16, granularity=None) -> ParamDef:
    return ParamDef(
        tuple(int(s) for s in shape), tuple(axes), init, scale, dtype,
        tuple(granularity) if granularity is not None else None,
    )


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _leaves(tree):
    return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]


def abstract(tree):
    """An empty ``meta`` tensor of each ``ParamDef``'s shape and dtype: the
    tree's stand-in for the dry run, which allocates nothing."""
    return nn.tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), tree)


# The most values ``materialize`` draws in one call.  A larger leaf is drawn
# in flat chunks of this size, so that its float32 temporaries stay a few GB
# (arctic-480b's stacked expert weights are 8.9e9 values a leaf at two
# layers, 71 GB of float32 drawn at once).  RecurrentGemma-2B's largest
# leaf, the 6.6e8-value embedding, is one chunk, drawn as one ``randn``.
DRAW_MAX = 1 << 30


def materialize(gen: Optional[torch.Generator], tree, dtype_override=None, device=None):
    """Tensors for a ``ParamDef`` tree, by the JAX package's per-leaf rule:
    zeros, ones, or ``normal * scale / sqrt(fan_in)`` with ``fan_in =
    shape[-2]`` (``shape[-1]`` for a vector), drawn in float32 from ``gen``
    and cast to the leaf's dtype (or ``dtype_override``).  A leaf of more
    than ``DRAW_MAX`` values is drawn chunk by chunk into its output.

    ``device=None`` means the GPU and raises without one; ``gen`` must live
    on the same device (``torch.Generator("cuda")``).  A tree of zeros and
    ones draws nothing and takes ``gen=None``.  torch's generator is not
    JAX's threefry, so the values differ from the JAX package's for the same
    seed; parity tests hand JAX-made parameters across instead.
    """
    device = nn.resolve_device(device, "materialize")

    def make(d: ParamDef) -> torch.Tensor:
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        out = torch.empty(d.shape, dtype=dt, device=device)
        for chunk in out.view(-1).split(DRAW_MAX):
            chunk.copy_(torch.randn(chunk.shape, generator=gen, dtype=torch.float32, device=device).mul_(std))
        return out

    return nn.tree_map(make, tree)


def count_params(tree) -> int:
    return int(sum(math.prod(d.shape) for d in _leaves(tree)))


def bytes_params(tree) -> int:
    return int(sum(math.prod(d.shape) * d.dtype.itemsize for d in _leaves(tree)))


# -- sharding rules --------------------------------------------------------------

Spec = Tuple[Any, ...]  # per dim: None, a mesh axis name, or a tuple of names


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> candidate mesh axes; the first candidate whose axes all
    exist in the mesh, are not used by another dim of the leaf, AND evenly
    divide the dim wins."""

    rules: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
        ("embed", ("data", None)),  # FSDP / ZeRO-3 analogue
        ("ff", ("model", None)),  # tensor parallel
        ("heads", ("model", None)),
        ("kv", ("model", None)),
        ("vocab", ("model", "data", None)),
        ("experts", ("model", None)),  # expert parallel
        ("batch", (("pod", "data"), "data", None)),  # data parallel (+pod)
        ("act_seq", (None,)),  # cache sequence dim; 'model' = flash-decode shard
        ("layers", (None,)),
    )

    def lookup(self, logical: Optional[str]) -> Tuple[Any, ...]:
        if logical is None:
            return (None,)
        for name, cands in self.rules:
            if name == logical:
                return cands
        return (None,)

    def replace(self, logical: str, cands: Tuple[Any, ...]) -> "ShardingRules":
        new = tuple((n, cands if n == logical else c) for (n, c) in self.rules)
        if logical not in [n for n, _ in self.rules]:
            new = new + ((logical, cands),)
        return ShardingRules(rules=new)


def mesh_shape(mesh) -> Mapping[str, int]:
    """Axis name -> size of a named DeviceMesh, or the mapping itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh, Mapping):
        return mesh
    raise TypeError(f"a mesh is a DeviceMesh with named dimensions or a mapping of axis sizes, not {type(mesh)}")


def _flat(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def spec_for(d: ParamDef, rules: ShardingRules, mesh) -> Spec:
    shape = mesh_shape(mesh)
    parts = []
    used = set()
    for i, (dim, logical) in enumerate(zip(d.shape, d.axes)):
        chosen = None
        units = dim // d.gran(i)  # shardable units (e.g. heads, not elements)
        for cand in rules.lookup(logical):
            if cand is None:
                break
            flat = _flat(cand)
            if not all(a in shape for a in flat) or any(a in used for a in flat):
                continue
            if units % math.prod(shape[a] for a in flat) == 0:
                chosen = cand
                used.update(flat)
                break
        parts.append(chosen)
    return tuple(parts)


def specs(tree, rules: ShardingRules, mesh):
    return nn.tree_map(lambda d: spec_for(d, rules, mesh), tree)


@dataclass(frozen=True)
class NamedSharding:
    """A DeviceMesh and the DTensor placements of ``spec`` on it (one per mesh
    dimension), as ``torch.distributed.tensor.distribute_tensor`` takes them."""

    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """``Shard(dim)`` on each mesh dimension that ``spec`` names for tensor
    dimension ``dim``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: i for i, part in enumerate(spec) if part is not None for a in _flat(part)}
    return tuple(Shard(where[a]) if a in where else Replicate() for a in mesh.mesh_dim_names)


def shardings(tree, rules: ShardingRules, mesh):
    """Per ``ParamDef`` the ``NamedSharding`` of its spec on ``mesh`` (a named DeviceMesh)."""

    def one(d: ParamDef) -> NamedSharding:
        spec = spec_for(d, rules, mesh)
        return NamedSharding(mesh, spec, placements(spec, mesh))

    return nn.tree_map(one, tree)
