"""Plain PyTorch version of the RG-LRU linear recurrence.

``h_t = a_t * h_{t-1} + b_t`` over T, one step at a time in fp32: the
sequential definition, which the CUDA kernel (``csrc/rglru.cu``) computes
with the same roundings.  The JAX package's oracle is an associative scan;
the two agree to fp32 rounding.
"""

from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D); h0: (B, D) -> h: (B, T, D) with h_t = a_t h_{t-1} + b_t."""
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = h0.to(torch.float32)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
