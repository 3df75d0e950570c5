"""Plain PyTorch versions of the segment gather / scatter ops.

The same index formulations as the JAX package's oracles: a row gather
(``take_along_axis`` there, ``torch.gather`` here) with a weighted sum over
the parent axis, and a scatter-add per graph (``.at[].add`` there,
``scatter_add_`` here).  States carry leading member axes; the index tables
and weights are per graph and shared by every member.
"""

from __future__ import annotations

import torch


def gather_sum_ref(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[..., b, r] = sum_p w[b, r, p] * h[..., b, idx[b, r, p]]``.

    ``h``: (*M, B, N, H) source states; ``idx``: (B, R, P) int row tables;
    ``w``: (B, R, P) per-entry weights (the parent masks / placed flags).
    """
    B, R, P = idx.shape
    lead, H = h.shape[:-3], h.shape[-1]
    flat = idx.long().reshape(B, R * P, 1).expand(*lead, B, R * P, H)
    gat = torch.gather(h, -2, flat).reshape(*lead, B, R, P, H)
    return (gat * w[..., None]).sum(dim=-2)


def segment_sum_ref(x: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``out[..., b, s] = sum_{r: seg[b, r] == s} x[..., b, r]`` for ``s < n_seg``.

    ``x``: (*M, B, N, H) row states (pre-masked: padded rows contribute zero);
    ``seg``: (B, N) int segment ids in [0, n_seg).
    """
    index = seg.long()[..., None].expand(x.shape)
    out = x.new_zeros((*x.shape[:-2], int(n_seg), x.shape[-1]))
    return out.scatter_add_(-2, index, x)
