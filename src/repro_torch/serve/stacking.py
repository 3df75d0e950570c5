"""Fused multi-metric ensembles + inference voting (serving-side numerics).

The per-metric GNNs share one architecture, so their ensemble params are
shape-identical trees with a leading (E,) member axis.  Stacking them along
that axis turns "one forward per (metric, member)" into ONE forward whose
member axis is sum(E_m): one kernel launch per GNN stage.  Voting stays
numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.model import CostModelConfig


def _ensemble_vote(raw: np.ndarray, cfg: CostModelConfig) -> np.ndarray:
    """(E, B) raw outputs -> cost-space prediction (paper SIV-A).

    regression: mean over members of expm1(raw); classification: majority vote
    over thresholded member probabilities -> {0,1}.
    """
    if cfg.task == "regression":
        return np.mean(np.expm1(raw), axis=0).clip(min=0.0)
    votes = (raw > 0.0).astype(np.int64)  # logit > 0 <=> p > 0.5
    return (votes.sum(axis=0) * 2 > votes.shape[0]).astype(np.int64)


class StackedEnsembles(NamedTuple):
    """Per-metric ensembles fused along the leading member axis.

    ``params`` leaves have shape ``(sum of member counts, ...)``; metric ``m``
    owns rows ``[offsets[i], offsets[i] + sizes[i])``.
    """

    params: object  # tree, leaves stacked along axis 0
    metrics: Tuple[str, ...]
    cfgs: Tuple[CostModelConfig, ...]
    sizes: Tuple[int, ...]  # members per metric, in ``metrics`` order


def stack_metric_models(
    models: Dict[str, Tuple[object, CostModelConfig]],
    metrics: Optional[Sequence[str]] = None,
) -> StackedEnsembles:
    """Fuse several per-metric (params, cfg) ensembles into one stack.

    Requires every model to share the same ``GNNConfig`` and
    ``traditional_mp`` flag; raises ``ValueError`` otherwise so callers can
    fall back to the per-metric loop explicitly.  Member counts may differ.
    """
    names = tuple(metrics) if metrics is not None else tuple(models)
    if not names:
        raise ValueError("no metrics to stack")
    cfgs = tuple(models[m][1] for m in names)
    for c in cfgs[1:]:
        if c.gnn != cfgs[0].gnn or c.traditional_mp != cfgs[0].traditional_mp:
            raise ValueError(
                "cannot fuse metric ensembles with differing GNN configs: "
                f"{cfgs[0].metric}={cfgs[0].gnn} vs {c.metric}={c.gnn} "
                f"(traditional_mp {cfgs[0].traditional_mp} vs {c.traditional_mp})"
            )
    trees = [models[m][0] for m in names]
    sizes = tuple(int(nn.tree_leaves_with_paths(t)[0][1].shape[0]) for t in trees)
    stacked = nn.tree_map(lambda *leaves: torch.cat(leaves, dim=0), *trees)
    return StackedEnsembles(stacked, names, cfgs, sizes)


def _split_votes(raw: np.ndarray, stacked: StackedEnsembles) -> Dict[str, np.ndarray]:
    """(sum_E, B) fused raw outputs -> per-metric cost-space predictions."""
    out, off = {}, 0
    for m, cfg, sz in zip(stacked.metrics, stacked.cfgs, stacked.sizes):
        out[m] = _ensemble_vote(raw[off : off + sz], cfg)
        off += sz
    return out
