"""Wrapper of the fused slotted banked 2-layer MLP kernel (``csrc/banked_mlp.cu``).

For tensors on the CPU it runs the plain version (``ref.py``); for tensors on
a GPU it launches the CUDA kernel or raises.  It never falls back.  The
member axis is explicit: ``x (E, B, N, F)`` with weights ``(E, T, ...)``, one
launch for all E members; ``x`` may be expanded along the member axis
(stride 0) when every member reads the same input.  Layer widths that are
no multiple of 8 run zero-padded (``kernels/common.py:pad_widths``), up to
128; wider layers raise.  On a GPU the launch runs
inside an ``autograd.Function`` whose backward is the VJP of the plain
version (``kernels/common.py``), as the JAX package's ``custom_vjp`` is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.common import check_untracked, oracle_vjp, pad_widths


def _layers(w1, b1, w2, b2):
    return {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}


def _check_ranges(slot_ranges, n_rows: int, n_types: int) -> Tuple[Tuple[int, int, int], ...]:
    ranges = tuple((int(t), int(a), int(b)) for t, a, b in slot_ranges)
    edge = 0
    for t, a, b in ranges:
        if a != edge or b <= a or not 0 <= t < n_types:
            raise ValueError(f"slot ranges must tile [0, {n_rows}) in order with types < {n_types}, got {ranges}")
        edge = b
    if edge != n_rows:
        raise ValueError(f"slot ranges must tile [0, {n_rows}), got {ranges}")
    return ranges


def banked_mlp_slotted(params, x: torch.Tensor, slot_ranges: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """Fused type-specific 2-layer MLP on a slot layout, every member at once.

    params: {"layers": [{"w": (E, T, F, H1), "b": (E, T, H1)},
    {"w": (E, T, H1, H2), "b": (E, T, H2)}]}; x: (E, B, N, F) -> (E, B, N, H2).
    """
    if len(params["layers"]) != 2:
        raise NotImplementedError(
            f"the banked-MLP kernel fuses exactly two layers, got {len(params['layers'])}"
        )
    (l1, l2) = params["layers"]
    w1, b1, w2, b2 = l1["w"], l1["b"], l2["w"], l2["b"]
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"banked_mlp_slotted takes float32 only; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"banked_mlp_slotted: {name} is on {t.device}, x on {x.device}")
    if x.ndim != 4 or w1.ndim != 4:
        raise ValueError(f"banked_mlp_slotted wants x (E, B, N, F) and W1 (E, T, F, H1); got {tuple(x.shape)}, {tuple(w1.shape)}")
    E, B, N, F = x.shape
    T, H1, H2 = w1.shape[1], w1.shape[3], w2.shape[3]
    if (
        tuple(w1.shape) != (E, T, F, H1)
        or tuple(b1.shape) != (E, T, H1)
        or tuple(w2.shape) != (E, T, H1, H2)
        or tuple(b2.shape) != (E, T, H2)
    ):
        raise ValueError(
            "banked_mlp_slotted: shapes disagree: x %s, w1 %s, b1 %s, w2 %s, b2 %s"
            % tuple(tuple(t.shape) for t in (x, w1, b1, w2, b2))
        )
    ranges = _check_ranges(slot_ranges, N, T)
    if x.device.type == "cpu":
        return banked_mlp_slotted_ref(params, x, ranges)
    if x.device.type != "cuda":
        raise ValueError(f"banked_mlp_slotted runs on the CPU or a CUDA device, not {x.device}")
    if not all(t.is_contiguous() for t in (w1, b1, w2, b2)):
        raise ValueError("banked_mlp_slotted: weights must be contiguous")
    if not x[0].is_contiguous() or x.stride(0) not in (0, B * N * F):
        raise ValueError(
            "banked_mlp_slotted: x must be contiguous, or one contiguous member "
            f"expanded along the member axis; strides {x.stride()}"
        )
    return _BankedMLP.apply(x, w1, b1, w2, b2, ranges)


def _launch(x, w1, b1, w2, b2, ranges) -> torch.Tensor:
    check_untracked("banked_mlp_slotted", x, w1, b1, w2, b2)
    H2 = w2.shape[3]
    if w1.shape[3] % 8 or H2 % 8:  # ragged widths: the kernel runs the bank zero-padded to multiples of 8
        return _launch(x, *pad_widths(w1, b1, w2, b2), ranges)[..., :H2].contiguous()
    E, B, N, F = x.shape
    T, H1 = w1.shape[1], w1.shape[3]
    y = torch.empty((E, B, N, H2), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    launch = _build.launcher("banked_mlp")
    err = launch(
        x.data_ptr(), x.stride(0), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), E, B, N, F, H1, H2, T, _build.SlotRanges.of(ranges),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("banked_mlp", err)
    obs.launch("banked_mlp_slotted")
    return y


class _BankedMLP(torch.autograd.Function):
    """The kernel launch, differentiable in ``x`` and the four weights."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ranges):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.ranges = ranges
        return _launch(x, w1, b1, w2, b2, ranges)

    @staticmethod
    def backward(ctx, g):
        def plain(x, w1, b1, w2, b2):
            return banked_mlp_slotted_ref(_layers(w1, b1, w2, b2), x, ctx.ranges)

        return (*oracle_vjp(ctx, plain, g, *ctx.saved_tensors), None)
