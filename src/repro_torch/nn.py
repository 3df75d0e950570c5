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

from repro_torch import obs

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


def _layout(specs) -> Tuple[int, Layout]:
    """Bytes of a buffer for arrays of ``(dtype, shape)``, each 8-byte aligned
    so it views back, and each array's ``(offset, bytes, dtype, shape)``."""
    layout, off = [], 0
    for dtype, shape in specs:
        nbytes = np.dtype(dtype).itemsize * math.prod(shape)
        layout.append((off, nbytes, torch.from_numpy(np.empty(0, dtype)).dtype, tuple(shape)))
        off += -(-nbytes // 8) * 8
    return max(off, 1), tuple(layout)


def _host_buffer(specs, pin: bool) -> Tuple[torch.Tensor, Layout]:
    """An empty host buffer (page-locked when ``pin``) in ``_layout(specs)``:
    the buffer and the layout."""
    size, layout = _layout(specs)
    return torch.empty((size,), dtype=torch.uint8, pin_memory=pin), layout


def device_buffer(specs, device) -> Tuple[torch.Tensor, list]:
    """An empty buffer on ``device`` in ``pack_host``'s layout for arrays of
    ``(dtype, shape)``, and those arrays as views of it: a fixed target for
    ``parts_to_device(..., into=)``."""
    size, layout = _layout(specs)
    buf = torch.empty((size,), dtype=torch.uint8, device=device)
    return buf, unpack(buf, layout)


def pack_host(arrays: Sequence[np.ndarray], pin: bool) -> Tuple[torch.Tensor, Layout]:
    """Pack numpy arrays into one host buffer (page-locked when ``pin``):
    the buffer and each array's ``(offset, bytes, dtype, shape)``."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    buf, layout = _host_buffer([(a.dtype, a.shape) for a in arrays], pin)
    host = buf.numpy()
    for (o, n, _, _), a in zip(layout, arrays):
        host[o : o + n] = a.reshape(-1).view(np.uint8)
    return buf, layout


def pack_host_parts(parts: Sequence[Sequence[np.ndarray]], pin: bool) -> Tuple[torch.Tensor, Layout]:
    """``pack_host`` of each field's parts joined along axis 0, with
    ``np.concatenate``'s values: the parts are written straight into the
    buffer, so their bytes are copied once and no joined array is made."""
    parts = [[np.asarray(p) for p in ps] for ps in parts]
    buf, layout = _host_buffer(
        [(np.result_type(*ps), (sum(len(p) for p in ps),) + ps[0].shape[1:]) for ps in parts], pin)
    for field, ps in zip(unpack(buf, layout), parts):
        np.concatenate(ps, axis=0, out=field.numpy())
    return buf, layout


def unpack(buf: torch.Tensor, layout: Layout) -> list:
    """The arrays of ``pack_host``'s layout as views of ``buf`` (on any device)."""
    return [buf[o : o + n].view(dtype).view(shape) for o, n, dtype, shape in layout]


def _host_allocs() -> Tuple[int, int]:
    """Page-locked blocks the caching host allocator has created so far, and their microseconds."""
    stats = torch.cuda.host_memory_stats_as_nested_dict()
    return stats.get("num_host_alloc", 0), stats.get("host_alloc_time", {}).get("total", 0)


def _copy_pinned(sp, pack, device, into: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Layout, list]:
    """``pack()``'s page-locked buffer and layout, and the layout's tensors on
    ``device`` after ONE ``non_blocking`` copy, into a new device buffer or
    into ``into``.  The caching host allocator records the copy on the stream
    and does not hand the buffer out again until the copy has run, so the
    caller may drop the buffer.  Sets on the span ``sp`` the blocks the
    allocator had to create (``pinned_allocs``, ``pinned_alloc_us``)."""
    before = _host_allocs() if sp.on else None
    buf, layout = pack()
    if into is None:
        out = unpack(buf.to(device, non_blocking=True), layout)
    elif into.dtype != torch.uint8 or into.shape != buf.shape:
        raise ValueError(f"into is {into.dtype} {tuple(into.shape)}, the layout needs uint8 "
                         f"{tuple(buf.shape)} (nn.device_buffer of the same specs)")
    else:
        out = unpack(into.copy_(buf, non_blocking=True), layout)
    if sp.on:
        allocs, us = _host_allocs()
        sp.set(pinned_allocs=allocs - before[0], pinned_alloc_us=us - before[1])
    return buf, layout, out


def arrays_to_device(arrays: Sequence[np.ndarray], device) -> list:
    """Numpy arrays as tensors on ``device``: views of the arrays on the CPU;
    on a GPU one page-locked staging buffer and ONE ``non_blocking`` copy, so
    the host never waits for the device's queued work (``_copy_pinned``).
    Traced as ``h2d.stage`` (``repro_torch.obs``): its bytes and, on a GPU,
    the page-locked blocks the caching host allocator had to create for it
    (``pinned_allocs``, ``pinned_alloc_us``)."""
    device = torch.device(device)
    with obs.span("h2d.stage") as sp:
        if device.type == "cpu":
            out = [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]
        else:
            out = _copy_pinned(sp, lambda: pack_host(arrays, pin=True), device)[2]
        if sp.on:
            sp.set(bytes=sum(int(t.nbytes) for t in out))
        return out


def parts_to_device(
    parts: Sequence[Sequence[np.ndarray]], device, into: Optional[torch.Tensor] = None
) -> Tuple[list, list]:
    """Each field's parts joined along axis 0, on the host and on ``device``:
    written straight into one staging buffer (``pack_host_parts``, page-locked
    on a GPU, where ONE ``non_blocking`` copy follows), so the bytes are copied
    once on the host.  Returns the joined host arrays, views of that buffer,
    and the tensors on ``device`` (on the CPU, views of the same buffer).  On
    a GPU, ``into`` (a ``device_buffer`` of the joined fields' specs) takes
    the copy, and the tensors on ``device`` are views of it.  Traced as
    ``h2d.stage``, with ``arrays_to_device``'s attributes."""
    device = torch.device(device)
    with obs.span("h2d.stage") as sp:
        if device.type == "cpu":
            buf, layout = pack_host_parts(parts, pin=False)
            out = unpack(buf, layout)
        else:
            buf, layout, out = _copy_pinned(sp, lambda: pack_host_parts(parts, pin=True), device, into)
        if sp.on:
            sp.set(bytes=sum(int(t.nbytes) for t in out))
        return [t.numpy() for t in unpack(buf, layout)], out


def index_tensor(values: Sequence[int], device) -> torch.Tensor:
    """An int64 index tensor on ``device`` without a host-device sync."""
    return arrays_to_device([np.asarray(values, dtype=np.int64)], device)[0]
