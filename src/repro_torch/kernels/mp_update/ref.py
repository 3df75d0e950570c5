"""Plain PyTorch version of the fused message-passing depth step."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref


def mp_update_ref(
    params,
    h: torch.Tensor,  # (*M, ..., N, H)
    a_flow: torch.Tensor,  # (..., N, N)  a_flow[u, v] = 1 iff u -> v
    depth: torch.Tensor,  # (..., N) int
    mask: torch.Tensor,  # (..., N) float {0,1}
    d,  # int: the depth level being updated
    slot_ranges: Sequence[Tuple[int, int, int]],
    row_span=None,  # (s, e): restrict the update to rows [s, e)
    parent_rows=None,  # p: a_flow[u, v] == 0 for u >= p, v in the span
    apply_fn=banked_mlp_slotted_ref,  # (params, x, slot_ranges) -> y
) -> torch.Tensor:
    """One SOURCES->OPS depth step: aggregate parents, update, select.

    Graph fields broadcast against ``h`` from the right, so a member axis on
    ``h`` (and on ``params``) and a shared ``(N, N)`` / ``(N,)`` skeleton
    both work.  With ``row_span=(s, e)`` only rows [s, e) are aggregated and
    updated (``slot_ranges`` are absolute rows inside the span); rows outside
    pass through.  ``parent_rows`` bounds the aggregation's contraction.
    """
    if row_span is None:
        msg = a_flow.transpose(-1, -2) @ h  # msg[v] = sum_{u: u->v} h[u]
        upd = apply_fn(params, torch.cat([h, msg], dim=-1), slot_ranges)
        sel = ((depth == d) & (mask > 0))[..., None]
        return torch.where(sel, upd, h)
    s, e = row_span
    p = a_flow.shape[-2] if parent_rows is None else parent_rows
    msg = a_flow[..., :p, s:e].transpose(-1, -2) @ h[..., :p, :]  # (..., e-s, H)
    z = torch.cat([h[..., s:e, :], msg], dim=-1)
    shifted = tuple((t, start - s, stop - s) for t, start, stop in slot_ranges)
    upd = apply_fn(params, z, shifted)
    sel = ((depth[..., s:e] == d) & (mask[..., s:e] > 0))[..., None]
    return torch.cat([h[..., :s, :], torch.where(sel, upd, h[..., s:e, :]), h[..., e:, :]], dim=-2)
