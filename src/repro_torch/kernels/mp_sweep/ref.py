"""Plain PyTorch version of the fused stage-3 depth sweep.

The sweep is, by definition, the sequential composition of one
``mp_update_ref`` step per banding level; this function IS that loop, so the
kernel's parity target and the per-level banded engine are the same
function.  ``apply_fn`` is injected as in ``mp_update_ref``: the plain GNN
path passes ``nn.apply_mlp_bank_slotted`` so banks of any depth work.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_update.ref import mp_update_ref


def mp_sweep_ref(
    params,
    h: torch.Tensor,  # (*M, ..., N, H)
    a_flow: torch.Tensor,  # (..., N, N)  a_flow[u, v] = 1 iff u -> v
    depth: torch.Tensor,  # (..., N) int
    mask: torch.Tensor,  # (..., N) float {0,1}
    levels,  # ((d, row_span, slot_ranges, parent_rows), ...)
    apply_fn=banked_mlp_slotted_ref,
) -> torch.Tensor:
    """Run every banding level's depth step in topological order."""
    for d, span, slot_ranges, parent_hi in levels:
        h = mp_update_ref(
            params, h, a_flow, depth, mask, d, slot_ranges,
            row_span=span, parent_rows=parent_hi, apply_fn=apply_fn,
        )
    return h
