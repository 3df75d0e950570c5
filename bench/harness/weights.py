"""The cost models' weights, made from the seed on the device.

Five metrics' ensembles of ``members`` GNNs in the program's parameter layout (``op_enc`` /
``op_upd`` type banks, ``hw_enc`` / ``hw_upd`` / ``out`` MLPs, each two layers), drawn as ONE
normal sample on the device and carved into leaves: weights at the Glorot-normal scale
``sqrt(2 / (fan_in + fan_out))``, biases at ``BIAS_SCALE`` so that a path that drops a bias reads
differently.  The same seed gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

N_TYPES = 5
OP_FEATURES = 39
HW_FEATURES = 4
BIAS_SCALE = 0.1


def layer_shapes(hidden: int) -> Dict[str, Tuple[bool, List[Tuple[int, int]]]]:
    """Module -> (is a type bank, [(fan_in, fan_out)] per layer) of one member."""
    h = hidden
    return {
        "op_enc": (True, [(OP_FEATURES, h), (h, h)]),
        "hw_enc": (False, [(HW_FEATURES, h), (h, h)]),
        "op_upd": (True, [(2 * h, h), (h, h)]),
        "hw_upd": (False, [(2 * h, h), (h, h)]),
        "out": (False, [(h, h), (h, 1)]),
    }


def make(seed: int, metrics, members: int, hidden: int, device) -> Dict[str, dict]:
    """metric -> parameter tree with a leading ``(members,)`` axis on every leaf, float32 on ``device``."""
    device = torch.device(device)
    shapes = layer_shapes(hidden)
    plan = []
    for m in metrics:
        for name, (bank, layers) in shapes.items():
            lead = (members, N_TYPES) if bank else (members,)
            for i, (fi, fo) in enumerate(layers):
                plan.append((m, name, i, "w", lead + (fi, fo), math.sqrt(2.0 / (fi + fo))))
                plan.append((m, name, i, "b", lead + (fo,), BIAS_SCALE))
    sizes = [math.prod(s) for *_, s, _ in plan]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    trees: Dict[str, dict] = {m: {n: {"layers": [{}, {}]} for n in shapes} for m in metrics}
    for (m, name, i, kind, shape, scale), part in zip(plan, torch.split(flat, sizes)):
        trees[m][name]["layers"][i][kind] = (part * scale).reshape(shape)
    return trees
