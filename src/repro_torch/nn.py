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


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, which must exist.

    ``who`` names the entry point in the error.  On a GPU the plain-PyTorch
    float32 matmuls stay in full fp32 (no TF32).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


# -- trees ----------------------------------------------------------------------


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (same structure);
    a NamedTuple (an optimizer state) stays one."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *items) for items in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's key path
    (the tuple of dict keys, NamedTuple field names and list indices, as
    strings: the JAX package's ``/``-joined checkpoint keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (k,)) for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_paths(tree):
    """``[(path, leaf)]`` in traversal order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def tree_map_n(fn, n: int, tree, *rest):
    """``n`` trees shaped like ``tree`` from ``fn``'s per-leaf ``n``-tuples."""
    results = []
    tree_map(lambda *leaves: results.append(fn(*leaves)), tree, *rest)
    trees = []
    for i in range(n):
        it = iter([r[i] for r in results])
        trees.append(tree_map(lambda _: next(it), tree))
    return trees


def tree_leaves(tree):
    """The leaves in the JAX package's flatten order (dict keys sorted), so a
    sum over them adds in the same order as ``jax.tree_util.tree_leaves``."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def params_from_numpy(tree, device="cpu") -> Params:
    """The JAX package's params tree (leaves as numpy arrays) as tensors.

    Keys and nesting are kept, so ``tree["op_enc"]["layers"][0]["w"]`` (or,
    for the LM stack, ``tree["groups"]["b0"]["rec"]["lam"]`` and the
    ``prefix`` / ``suffix`` lists) names the same weight in both packages.
    Arrays are copied: ``np.asarray`` of a JAX array is read-only, and the
    port never aliases caller memory.  A bfloat16 leaf (numpy's
    ``ml_dtypes.bfloat16``, as JAX hands bf16 arrays over) goes through
    float32, which holds every bfloat16 value exactly, to ``torch.bfloat16``.
    """

    def leaf(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        return torch.tensor(a, device=device)

    return tree_map(leaf, tree)


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


# -- host arrays to the device --------------------------------------------------

Layout = Tuple[Tuple[int, int, torch.dtype, Tuple[int, ...]], ...]


def pack_host(arrays: Sequence[np.ndarray], pin: bool) -> Tuple[torch.Tensor, Layout]:
    """Pack numpy arrays into one host buffer (page-locked when ``pin``):
    the buffer and each array's ``(offset, bytes, dtype, shape)``."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    layout, off = [], 0
    for a in arrays:
        layout.append((off, a.nbytes, torch.from_numpy(a).dtype, a.shape))
        off += -(-a.nbytes // 8) * 8  # 8-byte aligned, so every field views back
    buf = torch.empty((max(off, 1),), dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for (o, n, _, _), a in zip(layout, arrays):
        host[o : o + n] = a.reshape(-1).view(np.uint8)
    return buf, tuple(layout)


def unpack(buf: torch.Tensor, layout: Layout) -> list:
    """The arrays of ``pack_host``'s layout as views of ``buf`` (on any device)."""
    return [buf[o : o + n].view(dtype).view(shape) for o, n, dtype, shape in layout]


def arrays_to_device(arrays: Sequence[np.ndarray], device) -> list:
    """Numpy arrays as tensors on ``device``: views of the arrays on the CPU;
    on a GPU one page-locked staging buffer and ONE ``non_blocking`` copy, so
    the host never waits for the device's queued work.  The caching host
    allocator records the copy on the stream and does not hand the buffer
    out again until the copy has run, so the staging buffer may be dropped
    here."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]
    buf, layout = pack_host(arrays, pin=True)
    return unpack(buf.to(device, non_blocking=True), layout)


def index_tensor(values: Sequence[int], device) -> torch.Tensor:
    """An int64 index tensor on ``device`` without a host-device sync."""
    return arrays_to_device([np.asarray(values, dtype=np.int64)], device)[0]
