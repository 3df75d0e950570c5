"""COSTREAM cost models: per-metric GNN ensembles (paper SIV-A), in PyTorch.

The port of ``repro/core/model.py``'s numeric core for inference: configs,
init and the ensemble forward.  Five metrics, five separately trained
models sharing the GNN architecture: regression (throughput, processing
latency, e2e latency) with raw outputs in log1p space, classification
(backpressure occurrence, query success) with logits.  Ensembles of E members
share one forward with an explicit member axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import nn
from repro_torch.core.gnn import GNNConfig, apply_gnn_stacked, init_gnn
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
    One stacked engine forward evaluates every member.
    """
    if cfg.traditional_mp:
        raise NotImplementedError(
            "traditional_mp models (the Exp-7b ablation) are not ported yet: "
            "ROADMAP.md queue 1, item 8."
        )
    return apply_gnn_stacked(params, g, cfg.gnn, banding)
