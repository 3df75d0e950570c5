"""Wrapper of the fused stage-3 depth-step kernel (``csrc/mp_update.cu``).

For tensors on the CPU it runs the plain version (``ref.py``); for tensors on
a GPU it launches the CUDA kernel or raises.  It never falls back.  ``h`` has
an explicit member axis, ``(E, B, N, H)``, with weights ``(E, T, ...)``: one
launch for all E members.  The graph fields are per graph, ``a_flow
(B, N, N)``, ``depth``/``mask`` ``(B, N)``, or shared by the whole batch,
``(N, N)`` / ``(N,)``, which the kernel reads at batch stride 0.  Widths
that are no multiple of 8 run zero-padded (``kernels/common.py:pad_widths``),
up to 128; wider ones raise.  On a GPU the launch runs inside an
``autograd.Function`` differentiable in ``h``, ``a_flow`` and the weights,
whose backward is the VJP of the plain version (``kernels/common.py``); a
shared ``a_flow``'s gradient comes back summed over the batch, as JAX's
transpose of the broadcast gives it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.banked_mlp.ops import _layers
from repro_torch.kernels.common import check_untracked, oracle_vjp, pad_widths, round8
from repro_torch.kernels.mp_update.ref import mp_update_ref


def _batch_stride(what: str, t: torch.Tensor, name: str, n_batched: int, row_shape) -> int:
    """0 for a field shared by the batch, else its leading stride."""
    if tuple(t.shape[-len(row_shape):]) != tuple(row_shape) or t.ndim not in (len(row_shape), len(row_shape) + 1):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want (B?, {row_shape})")
    if t.ndim == len(row_shape):
        body = t
        stride = 0
    else:
        if t.shape[0] != n_batched:
            raise ValueError(f"{what}: {name} has batch {t.shape[0]}, h has {n_batched}")
        body, stride = t[0], t.stride(0)
    if not body.is_contiguous():
        raise ValueError(f"{what}: {name} rows must be contiguous; strides {t.stride()}")
    return stride


def check_step_operands(what: str, params, h, a_flow, depth, mask):
    """Validate the operands a stage-3 kernel (``mp_update``, ``mp_sweep``)
    takes; return ``(w1, b1, w2, b2, (E, B, N, H, T, H1), (a_bs, d_bs, m_bs))``
    with the graph fields' batch strides (0 when shared by the batch)."""
    if len(params["layers"]) != 2:
        raise NotImplementedError(f"the {what} kernel fuses exactly two layers, got {len(params['layers'])}")
    (l1, l2) = params["layers"]
    w1, b1, w2, b2 = l1["w"], l1["b"], l2["w"], l2["b"]
    for name, t in (("h", h), ("a_flow", a_flow), ("mask", mask), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 only; {name} is {t.dtype}")
    if depth.dtype != torch.int32:
        raise TypeError(f"{what}: depth must be int32, got {depth.dtype}")
    for name, t in (("a_flow", a_flow), ("depth", depth), ("mask", mask), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != h.device:
            raise ValueError(f"{what}: {name} is on {t.device}, h on {h.device}")
    if h.ndim != 4 or w1.ndim != 4:
        raise ValueError(f"{what} wants h (E, B, N, H) and W1 (E, T, 2H, H1); got {tuple(h.shape)}, {tuple(w1.shape)}")
    E, B, N, H = h.shape
    T, H1 = w1.shape[1], w1.shape[3]
    if (
        tuple(w1.shape) != (E, T, 2 * H, H1)
        or tuple(b1.shape) != (E, T, H1)
        or tuple(w2.shape) != (E, T, H1, H)
        or tuple(b2.shape) != (E, T, H)
    ):
        raise ValueError(
            f"{what}: shapes disagree: h %s, w1 %s, b1 %s, w2 %s, b2 %s"
            % tuple(tuple(t.shape) for t in (h, w1, b1, w2, b2))
        )
    strides = (
        _batch_stride(what, a_flow, "a_flow", B, (N, N)),
        _batch_stride(what, depth, "depth", B, (N,)),
        _batch_stride(what, mask, "mask", B, (N,)),
    )
    return w1, b1, w2, b2, (E, B, N, H, T, H1), strides


def check_level(what: str, row_span, slot_ranges, parent_rows, n_rows: int, n_types: int):
    """One stage-3 level's span, ranges and parent bound as ints:
    ``((s, e), ranges, p)``; raise unless the ranges tile the span in order."""
    s, e = (0, n_rows) if row_span is None else (int(row_span[0]), int(row_span[1]))
    if not 0 <= s < e <= n_rows:
        raise ValueError(f"{what}: row span {(s, e)} outside [0, {n_rows})")
    ranges = tuple((int(t), int(a), int(b)) for t, a, b in slot_ranges)
    edge = s
    for t, a, b in ranges:
        if a != edge or b <= a or not 0 <= t < n_types:
            raise ValueError(f"{what}: slot ranges must tile row span {(s, e)} in order, got {ranges}")
        edge = b
    if edge != e:
        raise ValueError(f"{what}: slot ranges must tile row span {(s, e)}, got {ranges}")
    p = n_rows if parent_rows is None else int(parent_rows)
    if not 0 < p <= n_rows:
        raise ValueError(f"{what}: parent_rows {p} outside (0, {n_rows}]")
    return (s, e), ranges, p


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
    w1, b1, w2, b2, (E, B, N, H, T, H1), (a_bs, d_bs, m_bs) = check_step_operands(
        "mp_update", params, h, a_flow, depth, mask
    )
    (s, e), ranges, p = check_level("mp_update", row_span, slot_ranges, parent_rows, N, T)
    d = int(d)
    plain_span = None if row_span is None else (s, e)
    plain_p = None if parent_rows is None else p
    if h.device.type == "cpu":
        return mp_update_ref(params, h, a_flow, depth, mask, d, ranges, plain_span, plain_p)
    if h.device.type != "cuda":
        raise ValueError(f"mp_update runs on the CPU or a CUDA device, not {h.device}")
    if not all(t.is_contiguous() for t in (h, w1, b1, w2, b2)):
        raise ValueError("mp_update: h and the weights must be contiguous")
    return _MPUpdate.apply(
        h, a_flow, w1, b1, w2, b2, depth, mask, (d, ranges, plain_span, plain_p, (s, e, p), (a_bs, d_bs, m_bs))
    )


def _launch(h, a_flow, w1, b1, w2, b2, depth, mask, d, ranges, bounds, strides) -> torch.Tensor:
    check_untracked("mp_update", h, a_flow, w1, b1, w2, b2)
    H = h.shape[3]
    if H % 8 or w1.shape[3] % 8:  # ragged widths: the state and the bank zero-padded to multiples of 8
        hp = F.pad(h, (0, round8(H) - H))
        out = _launch(hp, a_flow, *pad_widths(w1, b1, w2, b2, state=H), depth, mask, d, ranges, bounds, strides)
        return out[..., :H].contiguous()
    E, B, N, H = h.shape
    T, H1 = w1.shape[1], w1.shape[3]
    (s, e, p), (a_bs, d_bs, m_bs) = bounds, strides
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
    obs.launch("mp_update")
    return out


class _MPUpdate(torch.autograd.Function):
    """The kernel launch, differentiable in ``h``, ``a_flow`` and the weights;
    ``depth``, ``mask`` and the level (``static``) get no gradient."""

    @staticmethod
    def forward(ctx, h, a_flow, w1, b1, w2, b2, depth, mask, static):
        d, ranges, _, _, bounds, strides = static
        ctx.save_for_backward(h, a_flow, w1, b1, w2, b2, depth, mask)
        ctx.static = static
        return _launch(h, a_flow, w1, b1, w2, b2, depth, mask, d, ranges, bounds, strides)

    @staticmethod
    def backward(ctx, g):
        h, a_flow, w1, b1, w2, b2, depth, mask = ctx.saved_tensors
        d, ranges, span, p, _, _ = ctx.static

        def plain(h, a_flow, w1, b1, w2, b2):
            return mp_update_ref(_layers(w1, b1, w2, b2), h, a_flow, depth, mask, d, ranges, span, p)

        return (*oracle_vjp(ctx, plain, g, h, a_flow, w1, b1, w2, b2), None, None, None)
