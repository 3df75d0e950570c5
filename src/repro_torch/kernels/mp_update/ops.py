"""Wrapper of the fused stage-3 depth-step kernel (``csrc/mp_update.cu``).

For tensors on the CPU it runs the plain version (``ref.py``); for tensors on
a GPU it launches the CUDA kernel or raises.  It never falls back.  ``h`` has
an explicit member axis, ``(E, B, N, H)``, with weights ``(E, T, ...)``: one
launch for all E members.  The graph fields are per graph, ``a_flow
(B, N, N)``, ``depth``/``mask`` ``(B, N)``, or shared by the whole batch,
``(N, N)`` / ``(N,)``, which the kernel reads at batch stride 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mp_update.ref import mp_update_ref


def _batch_stride(t: torch.Tensor, name: str, n_batched: int, row_shape) -> int:
    """0 for a field shared by the batch, else its leading stride."""
    if tuple(t.shape[-len(row_shape):]) != tuple(row_shape) or t.ndim not in (len(row_shape), len(row_shape) + 1):
        raise ValueError(f"mp_update: {name} has shape {tuple(t.shape)}, want (B?, {row_shape})")
    if t.ndim == len(row_shape):
        body = t
        stride = 0
    else:
        if t.shape[0] != n_batched:
            raise ValueError(f"mp_update: {name} has batch {t.shape[0]}, h has {n_batched}")
        body, stride = t[0], t.stride(0)
    if not body.is_contiguous():
        raise ValueError(f"mp_update: {name} rows must be contiguous; strides {t.stride()}")
    return stride


def mp_update(
    params,
    h: torch.Tensor,
    a_flow: torch.Tensor,
    depth: torch.Tensor,
    mask: torch.Tensor,
    d: int,
    slot_ranges: Sequence[Tuple[int, int, int]],
    row_span: Tuple[int, int] = None,
    parent_rows: int = None,
) -> torch.Tensor:
    """Fused stage-3 depth step: aggregate -> concat -> banked MLP -> select.

    Returns a new ``(E, B, N, H)`` tensor: rows of the span ``row_span``
    (default: every row) at depth ``d`` with ``mask > 0`` take the update,
    every other row keeps ``h``.  ``slot_ranges`` must tile the span;
    ``parent_rows=p`` promises ``a_flow[u, v] == 0`` for ``u >= p`` and ``v``
    in the span, bounding the aggregation.
    """
    if len(params["layers"]) != 2:
        raise NotImplementedError(
            f"the mp-update kernel fuses exactly two layers, got {len(params['layers'])}"
        )
    (l1, l2) = params["layers"]
    w1, b1, w2, b2 = l1["w"], l1["b"], l2["w"], l2["b"]
    for name, t in (("h", h), ("a_flow", a_flow), ("mask", mask), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"mp_update takes float32 only; {name} is {t.dtype}")
    if depth.dtype != torch.int32:
        raise TypeError(f"mp_update: depth must be int32, got {depth.dtype}")
    for name, t in (("a_flow", a_flow), ("depth", depth), ("mask", mask), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != h.device:
            raise ValueError(f"mp_update: {name} is on {t.device}, h on {h.device}")
    if h.ndim != 4 or w1.ndim != 4:
        raise ValueError(f"mp_update wants h (E, B, N, H) and W1 (E, T, 2H, H1); got {tuple(h.shape)}, {tuple(w1.shape)}")
    E, B, N, H = h.shape
    T, H1 = w1.shape[1], w1.shape[3]
    if (
        tuple(w1.shape) != (E, T, 2 * H, H1)
        or tuple(b1.shape) != (E, T, H1)
        or tuple(w2.shape) != (E, T, H1, H)
        or tuple(b2.shape) != (E, T, H)
    ):
        raise ValueError(
            "mp_update: shapes disagree: h %s, w1 %s, b1 %s, w2 %s, b2 %s"
            % tuple(tuple(t.shape) for t in (h, w1, b1, w2, b2))
        )
    a_bs = _batch_stride(a_flow, "a_flow", B, (N, N))
    d_bs = _batch_stride(depth, "depth", B, (N,))
    m_bs = _batch_stride(mask, "mask", B, (N,))
    s, e = (0, N) if row_span is None else (int(row_span[0]), int(row_span[1]))
    if not 0 <= s < e <= N:
        raise ValueError(f"mp_update: row span {(s, e)} outside [0, {N})")
    ranges = tuple((int(t), int(a), int(b)) for t, a, b in slot_ranges)
    edge = s
    for t, a, b in ranges:
        if a != edge or b <= a or not 0 <= t < T:
            raise ValueError(f"mp_update: slot ranges must tile row span {(s, e)} in order, got {ranges}")
        edge = b
    if edge != e:
        raise ValueError(f"mp_update: slot ranges must tile row span {(s, e)}, got {ranges}")
    p = N if parent_rows is None else int(parent_rows)
    if not 0 < p <= N:
        raise ValueError(f"mp_update: parent_rows {p} outside (0, {N}]")
    d = int(d)
    if h.device.type == "cpu":
        return mp_update_ref(
            params, h, a_flow, depth, mask, d, ranges,
            None if row_span is None else (s, e), None if parent_rows is None else p,
        )
    if h.device.type != "cuda":
        raise ValueError(f"mp_update runs on the CPU or a CUDA device, not {h.device}")
    if not all(t.is_contiguous() for t in (h, w1, b1, w2, b2)):
        raise ValueError("mp_update: h and the weights must be contiguous")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    launch = _build.launcher("mp_update")
    err = launch(
        h.data_ptr(), out.data_ptr(), a_flow.data_ptr(), a_bs, depth.data_ptr(), d_bs,
        mask.data_ptr(), m_bs, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        E, B, N, H, H1, T, _build.SlotRanges.of(ranges), s, e, p, d,
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check("mp_update", err)
    mp_update.launches += 1
    return out


mp_update.launches = 0  # kernel launches (CUDA tensors only)
