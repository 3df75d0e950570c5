"""COSTREAM cost models: per-metric GNN ensembles (paper SIV-A), in PyTorch.

The port of ``repro/core/model.py``'s numeric core: configs, init, the
ensemble forward and the losses.  Five metrics, five separately trained
models sharing the GNN architecture: regression (throughput, processing
latency, e2e latency) trained with MSLE in log1p space, classification
(backpressure occurrence, query success) trained with BCE on logits.
Ensembles of E members share one forward with an explicit member axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.gnn import GNNConfig, apply_gnn_stacked, apply_gnn_traditional, init_gnn
from repro_torch.core.graph import BatchBanding, JointGraph

REGRESSION_METRICS = ("throughput", "latency_p", "latency_e")
CLASSIFICATION_METRICS = ("backpressure", "success")
ALL_METRICS = REGRESSION_METRICS + CLASSIFICATION_METRICS


@dataclass(frozen=True)
class CostModelConfig:
    metric: str = "latency_p"
    gnn: GNNConfig = GNNConfig()
    n_ensemble: int = 3
    traditional_mp: bool = False  # Exp-7b ablation

    @property
    def task(self) -> str:
        if self.metric in REGRESSION_METRICS:
            return "regression"
        if self.metric not in CLASSIFICATION_METRICS:
            raise ValueError(f"unknown metric {self.metric!r}")
        return "classification"


def init_cost_model(gen: torch.Generator, cfg: CostModelConfig) -> nn.Params:
    """Ensemble params on the CPU: every leaf gets a leading (n_ensemble,) axis."""
    per_member = [init_gnn(gen, cfg.gnn) for _ in range(cfg.n_ensemble)]
    return nn.tree_map(lambda *leaves: torch.stack(leaves), *per_member)


def forward_ensemble(
    params,
    g: JointGraph,
    cfg: CostModelConfig,
    banding: Optional[BatchBanding] = None,
) -> torch.Tensor:
    """(E-stacked params, batch of graphs) -> raw outputs (E, B).

    Raw output is log1p(cost) for regression, a logit for classification.
    One stacked engine forward evaluates every member; ``banding`` is the
    bucket's static stage-3 plan (None: the full-depth scan).  The
    ``traditional_mp`` ablation has no stage 3 and ignores ``banding``, as in
    the JAX package; its forward also takes every member at once.
    """
    if cfg.traditional_mp:
        return apply_gnn_traditional(params, g, cfg.gnn)[..., 0]
    return apply_gnn_stacked(params, g, cfg.gnn, banding)


# -- losses ---------------------------------------------------------------------


def msle_loss(raw: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared logarithmic error over the last axis; ``raw`` already
    lives in log1p space."""
    return torch.mean(torch.square(raw - torch.log1p(y)), dim=-1)


def bce_loss(raw: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits over the last axis, in the stable form
    ``max(r, 0) - r * y + log1p(exp(-|r|))``."""
    return torch.mean(torch.clamp(raw, min=0.0) - raw * y + torch.log1p(torch.exp(-torch.abs(raw))), dim=-1)


def loss_fn(cfg: CostModelConfig) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    return msle_loss if cfg.task == "regression" else bce_loss


def ensemble_loss(
    params,
    g: JointGraph,
    y: torch.Tensor,
    cfg: CostModelConfig,
    banding: Optional[BatchBanding] = None,
) -> torch.Tensor:
    """Sum of member losses (members are independent; grads don't mix)."""
    raw = forward_ensemble(params, g, cfg, banding)  # (E, B)
    return torch.sum(loss_fn(cfg)(raw, y))


def label_array(traces, metric: str) -> np.ndarray:
    return np.asarray([t.labels.as_dict()[metric] for t in traces], dtype=np.float32)
