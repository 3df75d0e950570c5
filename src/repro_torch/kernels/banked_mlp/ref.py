"""Plain PyTorch version of the fused slotted banked 2-layer MLP."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.nn import member_bias, member_matmul


def banked_mlp_slotted_ref(
    params,
    x: torch.Tensor,
    slot_ranges: Sequence[Tuple[int, int, int]],
) -> torch.Tensor:
    """x: (*M, ..., N, F) -> (*M, ..., N, H2).  Two layers, ReLU between.

    params follows ``nn.init_mlp_bank`` with optional leading member axes
    ``M``: {"layers": [{"w": (*M, T, F, H1), "b": (*M, T, H1)},
    {"w": (*M, T, H1, H2), "b": (*M, T, H2)}]}.
    """
    l1, l2 = params["layers"]
    pieces = []
    for t, start, stop in slot_ranges:
        h = member_matmul(x[..., start:stop, :], l1["w"][..., t, :, :])
        h = torch.relu(h + member_bias(l1["b"][..., t, :], h))
        y = member_matmul(h, l2["w"][..., t, :, :])
        pieces.append(y + member_bias(l2["b"][..., t, :], y))
    return torch.cat(pieces, dim=-2)
