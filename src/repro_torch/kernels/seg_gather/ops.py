"""Wrappers of the segment gather / scatter kernels (``csrc/seg_gather.cu``).

For tensors on the CPU they run the plain versions (``ref.py``); for tensors
on a GPU they launch the CUDA kernels or raise.  They never fall back.  The
member axis is explicit: states are ``(E, B, N, H)``, one launch for all E
members; the index tables and weights are per graph, ``(B, ...)``, shared by
every member.  Index operands are int64 (what ``argsort`` / ``argmax``
return) and are read as they are, never cast per call.  The kernels read
``idx`` / ``w`` / ``seg`` through their strides, so a column slice of a
wider table, or the layout a GPU sort returns, needs no copy.  On a GPU
each launch runs inside an ``autograd.Function`` whose backward is the VJP
of the plain version (``kernels/common.py``): ``gather_sum`` is
differentiable in ``h`` and ``w``, ``segment_sum`` in ``x``; the index
tables get no gradient.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_untracked, oracle_vjp
from repro_torch.kernels.seg_gather.ref import gather_sum_ref, segment_sum_ref


def _check_state(what: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 only; {name} is {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{what} wants {name} (E, B, N, H); got {tuple(t.shape)}")


def _check_index(what: str, name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: {name} must be int64, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, the states on {device}")


def gather_sum(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted row gather: ``out[e, b, r] = sum_p w[b, r, p] * h[e, b, idx[b, r, p]]``.

    The merged engine's parent-table aggregation (stage 3, ``P =
    max_parents`` with the parent mask as ``w``) and single-host gather
    (stage 2, ``P = 1`` with the placed flag as ``w``).  ``h``: (E, B, N, H);
    ``idx`` (int64) / ``w``: (B, R, P); out: (E, B, R, H).  On the GPU an
    index outside ``[0, N)`` contributes nothing.
    """
    _check_state("gather_sum", "h", h)
    E, B, N, H = h.shape
    if idx.ndim != 3 or idx.shape[0] != B:
        raise ValueError(f"gather_sum: idx must be (B={B}, R, P), got {tuple(idx.shape)}")
    _check_index("gather_sum", "idx", idx, h.device)
    R, P = idx.shape[1], idx.shape[2]
    if tuple(w.shape) != (B, R, P) or w.dtype != torch.float32 or w.device != h.device:
        raise ValueError(
            f"gather_sum: w must be float32 {(B, R, P)} on {h.device}; got {w.dtype} {tuple(w.shape)} on {w.device}"
        )
    if h.device.type == "cpu":
        return gather_sum_ref(h, idx, w)
    if h.device.type != "cuda":
        raise ValueError(f"gather_sum runs on the CPU or a CUDA device, not {h.device}")
    if not h.is_contiguous():
        raise ValueError(f"gather_sum: h must be contiguous; strides {h.stride()}")
    return _GatherSum.apply(h, w, idx)


def _launch_gather(h, w, idx) -> torch.Tensor:
    check_untracked("gather_sum", h, w)
    E, B, N, H = h.shape
    R, P = idx.shape[1], idx.shape[2]
    out = torch.empty((E, B, R, H), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("gather_sum")
    err = launch(
        h.data_ptr(), *((idx.data_ptr(),) + idx.stride()), *((w.data_ptr(),) + w.stride()),
        out.data_ptr(), E, B, N, R, P, H, h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check("gather_sum", err)
    obs.launch("gather_sum")
    return out


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, idx):
        ctx.save_for_backward(h, w, idx)
        return _launch_gather(h, w, idx)

    @staticmethod
    def backward(ctx, g):
        h, w, idx = ctx.saved_tensors
        return (*oracle_vjp(ctx, lambda h, w: gather_sum_ref(h, idx, w), g, h, w), None)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Segment scatter-add: ``out[e, b, s] = sum_{r: seg[b, r] == s} x[e, b, r]``.

    The merged engine's stage-1 OPS->HW aggregation (``seg`` = each
    operator's host index; rows must be pre-masked so padded operators
    contribute zero).  ``x``: (E, B, N, H); ``seg`` (int64): (B, N); out:
    (E, B, n_seg, H).  On the GPU a row whose id is outside ``[0, n_seg)``
    joins no segment.
    """
    _check_state("segment_sum", "x", x)
    E, B, N, H = x.shape
    if tuple(seg.shape) != (B, N):
        raise ValueError(f"segment_sum: seg has shape {tuple(seg.shape)}, want {(B, N)}")
    _check_index("segment_sum", "seg", seg, x.device)
    n_seg = int(n_seg)
    if n_seg < 1:
        raise ValueError(f"segment_sum: n_seg must be positive, got {n_seg}")
    if x.device.type == "cpu":
        return segment_sum_ref(x, seg, n_seg)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum runs on the CPU or a CUDA device, not {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"segment_sum: x must be contiguous; strides {x.stride()}")
    if N > 1 and seg.stride(1) != 1:
        raise ValueError(f"segment_sum: seg's rows must be contiguous; strides {seg.stride()}")
    return _SegmentSum.apply(x, seg, n_seg)


def _launch_segment(x, seg, n_seg: int) -> torch.Tensor:
    check_untracked("segment_sum", x)
    E, B, N, H = x.shape
    out = torch.empty((E, B, n_seg, H), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("segment_sum")
    err = launch(
        x.data_ptr(), seg.data_ptr(), seg.stride(0), out.data_ptr(), E, B, N, n_seg, H,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("segment_sum", err)
    obs.launch("segment_sum")
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, n_seg):
        ctx.save_for_backward(x, seg)
        ctx.n_seg = n_seg
        return _launch_segment(x, seg, n_seg)

    @staticmethod
    def backward(ctx, g):
        x, seg = ctx.saved_tensors
        return (*oracle_vjp(ctx, lambda x: segment_sum_ref(x, seg, ctx.n_seg), g, x), None, None)
