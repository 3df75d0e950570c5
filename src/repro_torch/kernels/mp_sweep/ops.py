"""Wrapper of the fused stage-3 depth-sweep kernel (``csrc/mp_sweep.cu``).

For tensors on the CPU it runs the plain version (``ref.py``); for tensors on
a GPU it launches the CUDA kernel or raises.  It never falls back.  Shapes
are those of ``mp_update``: ``h (E, B, N, H)`` with weights ``(E, T, ...)``,
one launch for all E members, and graph fields per graph (``a_flow
(B, N, N)``, ``depth``/``mask`` ``(B, N)``) or shared by the batch
(``(N, N)`` / ``(N,)``, read at batch stride 0).  The level table travels
to the kernel by value (``_build.SweepLevels``), so one build serves every
banding.  Widths that are no multiple of 8 run zero-padded
(``kernels/common.py:pad_widths``), up to 128; wider ones raise.  On a GPU
the launch runs inside an ``autograd.Function`` differentiable in ``h``,
``a_flow`` and the weights, whose backward is the VJP of the plain sweep
(``kernels/common.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.banked_mlp.ops import _layers
from repro_torch.kernels.common import check_untracked, oracle_vjp, pad_widths, round8
from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
from repro_torch.kernels.mp_update.ops import check_level, check_step_operands


def mp_sweep(params, h: torch.Tensor, a_flow: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor, levels) -> torch.Tensor:
    """Every banding level's depth step in ONE kernel launch.

    ``levels`` is the banding table exactly as ``gnn.StagePlan`` carries it:
    per level ``(d, row_span | None, slot_ranges, parent_rows | None)``, at
    most ``_build.MAX_LEVELS`` levels of at most ``_build.MAX_RANGES``
    ranges each.  Level ``k`` reads the state that level ``k - 1`` left:
    rows of its span at depth ``d`` with ``mask > 0`` take the update, every
    other row keeps its state, and every message of a level is computed from
    the state before that level writes.  Empty ``levels`` returns ``h``.
    """
    w1, b1, w2, b2, (E, B, N, H, T, H1), (a_bs, d_bs, m_bs) = check_step_operands(
        "mp_sweep", params, h, a_flow, depth, mask
    )
    levels = tuple((int(d), *check_level("mp_sweep", span, ranges, p, N, T)) for d, span, ranges, p in levels)
    if not levels:  # a depth-0-only batch has no sweep work at all
        return h
    if h.device.type == "cpu":
        return mp_sweep_ref(params, h, a_flow, depth, mask, levels)
    if h.device.type != "cuda":
        raise ValueError(f"mp_sweep runs on the CPU or a CUDA device, not {h.device}")
    if not all(t.is_contiguous() for t in (h, w1, b1, w2, b2)):
        raise ValueError("mp_sweep: h and the weights must be contiguous")
    return _MPSweep.apply(h, a_flow, w1, b1, w2, b2, depth, mask, (levels, (a_bs, d_bs, m_bs)))


def _launch(h, a_flow, w1, b1, w2, b2, depth, mask, levels, strides) -> torch.Tensor:
    check_untracked("mp_sweep", h, a_flow, w1, b1, w2, b2)
    H = h.shape[3]
    if H % 8 or w1.shape[3] % 8:  # ragged widths: the state and the bank zero-padded to multiples of 8
        hp = F.pad(h, (0, round8(H) - H))
        out = _launch(hp, a_flow, *pad_widths(w1, b1, w2, b2, state=H), depth, mask, levels, strides)
        return out[..., :H].contiguous()
    E, B, N, H = h.shape
    T, H1 = w1.shape[1], w1.shape[3]
    a_bs, d_bs, m_bs = strides
    table = _build.SweepLevels.of(levels)
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    launch = _build.launcher("mp_sweep")
    err = launch(
        h.data_ptr(), out.data_ptr(), a_flow.data_ptr(), a_bs, depth.data_ptr(), d_bs,
        mask.data_ptr(), m_bs, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        E, B, N, H, H1, T, table, h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check("mp_sweep", err)
    obs.launch("mp_sweep")
    return out


class _MPSweep(torch.autograd.Function):
    """The kernel launch, differentiable in ``h``, ``a_flow`` and the weights;
    ``depth``, ``mask`` and the level table (``static``) get no gradient."""

    @staticmethod
    def forward(ctx, h, a_flow, w1, b1, w2, b2, depth, mask, static):
        levels, strides = static
        ctx.save_for_backward(h, a_flow, w1, b1, w2, b2, depth, mask)
        ctx.levels = levels
        return _launch(h, a_flow, w1, b1, w2, b2, depth, mask, levels, strides)

    @staticmethod
    def backward(ctx, g):
        h, a_flow, w1, b1, w2, b2, depth, mask = ctx.saved_tensors

        def plain(h, a_flow, w1, b1, w2, b2):
            return mp_sweep_ref(_layers(w1, b1, w2, b2), h, a_flow, depth, mask, ctx.levels)

        return (*oracle_vjp(ctx, plain, g, h, a_flow, w1, b1, w2, b2), None, None, None)
