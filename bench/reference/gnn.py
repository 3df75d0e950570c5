"""The plain reference's cost model: COSTREAM's 3-stage message-passing GNN ensemble (paper Sec. IV-A).

Plain PyTorch over the padded graphs of ``featurize.py``, every (metric, member) pair at once along
a leading member axis, in float32 with TF32 off:

  stage 0   h_op = MLP_type(op_x), h_hw = MLP_hw(hw_x)               (masked)
  stage 1   h_hw = MLP_hw_upd([h_hw, A_place^T h_op])                (masked)
  stage 2   h_op = MLP_type_upd([h_op, A_place h_hw])                (masked)
  stage 3   for d in 1..MAX_DEPTH: rows at depth d take MLP_type_upd([h_op, A_flow^T h_op])
  readout   MLP_out(sum of every row of h_op and h_hw)

Every MLP has two layers with a ReLU between them.  Type-specific MLPs run every type's weights on
every row and keep the row's own type.  ``precision="tf32"`` computes the same with every product's
operands in TF32 (the control): on a GPU through the tensor cores, on the CPU by rounding the
operands to TF32 (10 mantissa bits, to nearest even).  It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.reference.featurize import MAX_DEPTH, N_TYPES, Graphs

REGRESSION = ("throughput", "latency_p", "latency_e")


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Math:
    def __init__(self, precision: str, device: torch.device):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.emulate = precision == "tf32" and device.type == "cpu"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (E, ..., K) @ w (E, K, H)`` per member."""
        if self.emulate:
            x, w = _tf32_round(x), _tf32_round(w)
        lead = x.shape[:-1]
        y = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), w)
        return y.reshape(*lead, w.shape[-1])

    def adj(self, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``a (B, M, N) @ h (E, B, N, H)`` for every member."""
        if self.emulate:
            a, h = _tf32_round(a), _tf32_round(h)
        return torch.matmul(a, h)

    def mlp(self, p, x: torch.Tensor) -> torch.Tensor:
        (l1, l2) = p["layers"]
        y = torch.relu(self.mm(x, l1["w"]) + l1["b"].reshape(l1["b"].shape[0], *([1] * (x.ndim - 2)), -1))
        return self.mm(y, l2["w"]) + l2["b"].reshape(l2["b"].shape[0], *([1] * (x.ndim - 2)), -1)

    def bank(self, p, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        """Type-specific MLP: every type's weights on every row, the row's own type kept."""
        out = 0.0
        for t in range(N_TYPES):
            one = {"layers": [{"w": l["w"][:, t], "b": l["b"][:, t]} for l in p["layers"]]}
            out = out + self.mlp(one, x) * onehot[..., t : t + 1]
        return out


def forward(params, g: Graphs, device="cpu", precision: str = "fp32") -> torch.Tensor:
    """Raw outputs ``(E, B)`` (log1p cost for regression, a logit for classification) of the
    member-stacked ``params`` over the graphs ``g`` (NumPy arrays)."""
    device = torch.device(device)
    m = _Math(precision, device)
    t = {f: torch.as_tensor(np.ascontiguousarray(x), device=device) for f, x in zip(Graphs._fields, g)}
    onehot = torch.nn.functional.one_hot(t["op_type"].long(), N_TYPES).float()
    op_mask = t["op_mask"][..., None]
    hw_mask = t["hw_mask"][..., None]
    E = params["out"]["layers"][0]["w"].shape[0]

    def members(x):
        return x.expand(E, *x.shape)

    h_op = m.bank(params["op_enc"], members(t["op_x"]), onehot) * op_mask
    h_hw = m.mlp(params["hw_enc"], members(t["hw_x"])) * hw_mask
    h_hw = m.mlp(params["hw_upd"], torch.cat([h_hw, m.adj(t["a_place"].transpose(-1, -2), h_op)], -1)) * hw_mask
    h = m.bank(params["op_upd"], torch.cat([h_op, m.adj(t["a_place"], h_hw)], -1), onehot) * op_mask
    flow_in = t["a_flow"].transpose(-1, -2)
    real = t["op_mask"] > 0
    for d in range(1, MAX_DEPTH + 1):
        upd = m.bank(params["op_upd"], torch.cat([h, m.adj(flow_in, h)], -1), onehot)
        h = torch.where(((t["op_depth"] == d) & real)[..., None], upd, h)
    pooled = h.sum(-2) + h_hw.sum(-2)
    return m.mlp(params["out"], pooled)[..., 0]


@contextlib.contextmanager
def precision_mode(precision: str, device):
    """TF32 on the GPU's matmuls for the control, off otherwise; the previous setting restored."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def raw_outputs(params, g: Graphs, device="cpu", precision: str = "fp32", block: int = 2048) -> np.ndarray:
    """``forward`` in blocks of ``block`` graphs, as a NumPy ``(E, B)`` float32 array."""
    n = g.op_x.shape[0]
    out: List[np.ndarray] = []
    with torch.no_grad(), precision_mode(precision, device):
        for s in range(0, n, block):
            out.append(forward(params, Graphs(*[x[s : s + block] for x in g]), device, precision).cpu().numpy())
    return np.concatenate(out, axis=1) if out else np.zeros((0, 0), np.float32)


def vote(raw: np.ndarray, metric: str) -> np.ndarray:
    """Cost-space answer of one metric's members ``(E_m, B)``: the mean of expm1 clipped at 0 for a
    regression metric, the majority of the members' ``logit > 0`` for a classification one."""
    if metric in REGRESSION:
        return np.mean(np.expm1(raw.astype(np.float64)), axis=0).clip(min=0.0)
    votes = (raw > 0.0).astype(np.int64)
    return (votes.sum(axis=0) * 2 > votes.shape[0]).astype(np.int64)


def stack(per_metric: Dict[str, object], metrics: Sequence[str]):
    """Per-metric parameter trees ``(E_m, ...)`` concatenated along the member axis, in ``metrics`` order."""

    def cat(*leaves):
        return torch.cat(leaves, 0)

    def walk(*trees):
        if isinstance(trees[0], dict):
            return {k: walk(*(t[k] for t in trees)) for k in trees[0]}
        if isinstance(trees[0], list):
            return [walk(*items) for items in zip(*trees)]
        return cat(*trees)

    return walk(*(per_metric[m] for m in metrics))
