"""Minimal functional NN substrate in PyTorch (the port of ``repro/nn.py``).

Parameters are plain nested dicts/lists of tensors with the JAX package's key
paths (``{"layers": [{"w": ..., "b": ...}, ...]}``), so a params tree crosses
between the packages leaf for leaf (``params_from_numpy``).

Every apply function takes an optional **leading member axis** on the
parameters: a weight ``w`` of shape ``(*M, F, H)`` applies member ``m`` of
``M`` to ``x[m]``, where ``x`` has shape ``(*M, ..., F)``.  With ``M = ()``
the functions are exactly the JAX package's.  The member axis is what
``jax.vmap`` over ensemble members gave the JAX package; here it is written
out, so an ensemble runs as one batched matmul per layer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, object]


# -- trees ----------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's key path
    (the tuple of dict keys / list indices, as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_paths(tree):
    """``[(path, leaf)]`` in traversal order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def params_from_numpy(tree, device="cpu") -> Params:
    """The JAX package's params tree (leaves as numpy arrays) as tensors.

    Keys and nesting are kept, so ``tree["op_enc"]["layers"][0]["w"]`` names
    the same weight in both packages.  Arrays are copied: ``np.asarray`` of
    a JAX array is read-only, and the port never aliases caller memory.
    """
    return tree_map(lambda a: torch.tensor(np.array(a, copy=True), device=device), tree)


def members(tree) -> Params:
    """Add a leading member axis of size 1 to every leaf."""
    return tree_map(lambda t: t.unsqueeze(0), tree)


# -- initializers -------------------------------------------------------------


def glorot(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def init_linear(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    return {"w": glorot(gen, (d_in, d_out)), "b": torch.zeros((d_out,), dtype=torch.float32)}


def init_mlp(gen: torch.Generator, sizes: Sequence[int]) -> Params:
    return {"layers": [init_linear(gen, sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]}


def init_mlp_bank(gen: torch.Generator, n_types: int, sizes: Sequence[int]) -> Params:
    layers = []
    for i in range(len(sizes) - 1):
        w = torch.stack([glorot(gen, (sizes[i], sizes[i + 1])) for _ in range(n_types)])
        layers.append({"w": w, "b": torch.zeros((n_types, sizes[i + 1]), dtype=torch.float32)})
    return {"layers": layers}


# -- dense / MLP ---------------------------------------------------------------


def member_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (*M, ..., K) @ w (*M, K, H) -> (*M, ..., H)`` per member."""
    m = w.ndim - 2
    if m == 0:
        return x @ w
    lead, mid = x.shape[:m], x.shape[m:-1]
    y = torch.matmul(x.reshape(*lead, -1, x.shape[-1]), w)
    return y.reshape(*lead, *mid, w.shape[-1])


def member_bias(b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``b (*M, H)`` viewed to broadcast against ``y (*M, ..., H)``."""
    m = b.ndim - 1
    return b.reshape(*b.shape[:m], *([1] * (y.ndim - m - 1)), b.shape[-1])


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = member_matmul(x, p["w"])
    return y + member_bias(p["b"], y)


def apply_mlp(
    p: Params, x: torch.Tensor, act: Callable[[torch.Tensor], torch.Tensor] = torch.relu
) -> torch.Tensor:
    layers = p["layers"]
    for i, layer in enumerate(layers):
        x = apply_linear(layer, x)
        if i < len(layers) - 1:
            x = act(x)
    return x


# -- banked (per-node-type) MLPs ------------------------------------------------


def apply_mlp_bank(
    p: Params,
    x: torch.Tensor,
    type_onehot: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
) -> torch.Tensor:
    """x: (*M, ..., N, F); type_onehot: (..., N, T) -> (*M, ..., N, H).

    Per layer, each node takes its type's weights through the one-hot:
    ``y = x @ W[t(n)] + b[t(n)]``, as T masked GEMMs.
    """
    layers = p["layers"]
    n_types = layers[0]["w"].shape[-3]
    for i, layer in enumerate(layers):
        b = layer["b"]  # (*M, T, H)
        m = b.ndim - 2
        y = member_matmul(type_onehot.expand(*b.shape[:m], *type_onehot.shape), b)
        for t in range(n_types):
            y = y + member_matmul(x * type_onehot[..., t : t + 1], layer["w"][..., t, :, :])
        x = act(y) if i < len(layers) - 1 else y
    return x


def apply_mlp_bank_slotted(
    p: Params,
    x: torch.Tensor,
    slot_ranges: Sequence[Tuple[int, int, int]],
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
) -> torch.Tensor:
    """Banked MLP over a canonical slot layout: every node of type t lives in
    the static row range [start, stop).  ``slot_ranges``: (type, start, stop).
    x: (*M, ..., N, F) -> (*M, ..., N, H); the ranges must tile the rows."""
    layers = p["layers"]
    for i, layer in enumerate(layers):
        pieces = []
        for t, start, stop in slot_ranges:
            y = member_matmul(x[..., start:stop, :], layer["w"][..., t, :, :])
            pieces.append(y + member_bias(layer["b"][..., t, :], y))
        y = torch.cat(pieces, dim=-2)
        x = act(y) if i < len(layers) - 1 else y
    return x


def to_device(params, device: Optional[torch.device]) -> Params:
    return tree_map(lambda t: t.to(device), params)
