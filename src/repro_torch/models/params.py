"""Parameter declarations for the LM stack (port of ``repro/models/params.py``).

A model definition builds a tree (nested dicts and lists) of ``ParamDef``
leaves.  From that one tree come the parameter count and bytes, and
``materialize`` makes the tensors.  Each leaf keeps the JAX package's logical
sharding axes so that definitions copy over unchanged; the sharding rules
that read them (``ShardingRules``, ``specs``) wait for the mesh work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import nn


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for "normal" (fan-in scaled)
    dtype: torch.dtype = torch.bfloat16
    # sharding granularity per dim (head dims: head_dim), kept for the mesh work
    granularity: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef: shape {self.shape} and axes {self.axes} differ in rank")
        if self.granularity is not None and len(self.granularity) != len(self.shape):
            raise ValueError(f"ParamDef: granularity {self.granularity} does not match shape {self.shape}")


def pdef(shape, axes, init="normal", scale=1.0, dtype=torch.bfloat16, granularity=None) -> ParamDef:
    return ParamDef(
        tuple(int(s) for s in shape), tuple(axes), init, scale, dtype,
        tuple(granularity) if granularity is not None else None,
    )


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _leaves(tree):
    return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]


def materialize(gen: Optional[torch.Generator], tree, dtype_override=None, device=None):
    """Tensors for a ``ParamDef`` tree, by the JAX package's per-leaf rule:
    zeros, ones, or ``normal * scale / sqrt(fan_in)`` with ``fan_in =
    shape[-2]`` (``shape[-1]`` for a vector), drawn in float32 from ``gen``
    and cast to the leaf's dtype (or ``dtype_override``).

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
        return (std * torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)).to(dt)

    return nn.tree_map(make, tree)


def count_params(tree) -> int:
    return int(sum(math.prod(d.shape) for d in _leaves(tree)))


def bytes_params(tree) -> int:
    return int(sum(math.prod(d.shape) * d.dtype.itemsize for d in _leaves(tree)))
