"""Wrapper of the RG-LRU linear-scan kernel (``csrc/rglru.cu``).

For tensors on the CPU it runs the plain version (``ref.py``); for tensors on
a GPU it launches the CUDA kernel or raises.  It never falls back.  The
kernel reads ``a``, ``b`` and ``h0`` through their strides, so a
non-contiguous input (``h0`` as a slice of a stacked cache, a step slice of
a wider tensor) needs no copy; the output is a new contiguous tensor.  There
is no backward yet: the JAX package's backward is its oracle's VJP, and the
port's ``autograd.Function`` comes with LM training (ROADMAP.md queue 1,
item 10); until then a launch on an input that requires grad raises rather
than return a result autograd cannot see.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_untracked
from repro_torch.kernels.rglru.ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over T: a, b (B, T, D), h0 (B, D), all
    float32 on one device -> h (B, T, D) float32.  T = 0 gives an empty
    result and launches nothing."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"linear_scan takes float32 only; {name} is {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"linear_scan: {name} is on {t.device}, a on {a.device}")
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"linear_scan wants a and b (B, T, D) of one shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    B, T, D = a.shape
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"linear_scan wants h0 {(B, D)}; got {tuple(h0.shape)}")
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on the CPU or a CUDA device, not {a.device}")
    check_untracked("linear_scan", a, b, h0, why=" (its backward comes with LM training: ROADMAP.md queue 1, item 10)")
    out = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("linear_scan")
    err = launch(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), h0.data_ptr(), *h0.stride(), out.data_ptr(),
        B, T, D, a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check("linear_scan", err)
    linear_scan.launches += 1
    return out


linear_scan.launches = 0  # kernel launches (CUDA tensors only)
