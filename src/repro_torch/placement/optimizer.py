"""Cost-based placement optimizer (paper SV, Fig. 4).

Vectorized single-materialization search pipeline:

  sample -> build once -> score all metrics -> refine -> argopt

1. ``sample_assignment_matrix`` draws the candidate set as an ``(N, n_ops)``
   matrix with batched rule checks (no per-candidate Python loop).
2. Scoring goes through the shared ``CostEstimator`` facade
   (``repro_torch.serve.estimator``): skeleton built once per (query, cluster)
   pair (LRU-amortized across calls), ALL requested metric ensembles fused
   into one bucket-padded stacked forward per batch — the device-side
   analogue of the paper's "parallel COSTREAM instances".
3. An optional hill-climb refinement loop mutates the top-k candidates and
   re-scores the children through the same batched path, so search quality
   scales with compute instead of with the initial sample's luck.

Since the serving redesign (docs/api.md) this class is a thin *search
strategy* layer: all model state, caches, and forwards live on the
estimator; the optimizer contributes candidate sampling, the feasibility
filter, and the refinement loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import batch_graphs, bucket_size, build_graph
from repro_torch.core.model import CostModelConfig
from repro_torch.dsps.hardware import Cluster
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import Query
from repro_torch.placement.enumerate import (
    dedup_assignments,
    mutate_assignments,
    sample_assignment_matrix,
)
from repro_torch.serve.estimator import CostEstimator


@dataclass
class OptimizerResult:
    placement: Placement
    predicted: Dict[str, float]
    n_candidates: int
    n_feasible: int
    candidates: List[Placement]
    scores: np.ndarray  # predicted target metric per candidate


class PlacementOptimizer:
    """Selects initial placements by scoring candidates with a CostEstimator.

    Construct from a metric -> (params, CostModelConfig) dict (the legacy
    shape), an existing ``CostEstimator`` (shares its caches), or a saved
    bundle via ``from_bundle``.  Requires the target metric plus (when
    available) "success" and "backpressure" for the sanity filter; missing
    filters degrade gracefully (the paper's procedure needs them, our
    ablations can disable them).
    """

    def __init__(self, models, device=None):
        self.estimator = (
            models if isinstance(models, CostEstimator) else CostEstimator(models, device=device)
        )

    @classmethod
    def from_bundle(cls, bundle, device=None) -> "PlacementOptimizer":
        return cls(CostEstimator.from_bundle(bundle, device=device))

    @property
    def models(self) -> Dict[str, Tuple[object, CostModelConfig]]:
        return self.estimator.models

    def score_candidates(
        self, query: Query, cluster: Cluster, candidates: List[Placement], metric: str
    ) -> np.ndarray:
        """Legacy per-metric path: rebuilds the graph batch on every call.

        Kept as the reference implementation (and the benchmark baseline);
        prefer ``score_assignments`` / ``CostEstimator.score`` which build
        once for all metrics.
        """
        singles = [build_graph(query, cluster, p) for p in candidates]
        # pad to a shape bucket so the jitted scorer doesn't retrace per count
        n = len(singles)
        singles = singles + [singles[-1]] * (bucket_size(n) - n)
        return self.estimator.estimate(batch_graphs(singles), [metric])[metric][:n]

    def score_assignments(
        self,
        query: Query,
        cluster: Cluster,
        assignments: np.ndarray,
        metrics: Sequence[str],
    ) -> Dict[str, np.ndarray]:
        """Fast path: build the candidate batch ONCE, score every metric on it.

        Delegates to ``CostEstimator.score`` (docs/api.md); returns metric ->
        ``(N,)`` predictions, bucket- and batchmate-independent.
        """
        return self.estimator.score(query, cluster, assignments, metrics)

    @staticmethod
    def _feasible_mask(
        scores: Dict[str, np.ndarray], n: int, filter_metrics: Sequence[str]
    ) -> np.ndarray:
        feasible = np.ones(n, dtype=bool)
        for m in filter_metrics:
            feasible &= scores[m].astype(bool)  # 1 = success / no backpressure
        if not feasible.any():
            feasible = np.ones(n, dtype=bool)  # nothing passes: rank all
        return feasible

    def optimize(
        self,
        query: Query,
        cluster: Cluster,
        target_metric: str = "latency_p",
        k: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        minimize: Optional[bool] = None,
        require_feasible: bool = True,
        refine_rounds: int = 0,
        refine_top: Optional[int] = None,
        refine_mutations: int = 4,
    ) -> OptimizerResult:
        """``refine_rounds`` is opt-in: hill-climbing maximizes the *predicted*
        objective, which with a weak model can chase model error instead of
        real cost. Enable it (2-3 rounds) for well-trained ensembles or
        oracle scorers; the default matches the paper's sample-and-argopt.

        ``k`` (candidate pool) and ``refine_top`` (elites per round) default
        from the estimator's ``DispatchPolicy`` (``search_k``/``refine_top``):
        search breadth is a cost/accuracy dial the host profile owns."""
        policy = self.estimator.policy
        k = policy.search_k if k is None else k
        refine_top = policy.refine_top if refine_top is None else refine_top
        rng = rng or np.random.default_rng(0)
        pool = sample_assignment_matrix(query, cluster, k, rng)
        if not len(pool):
            raise ValueError("no valid placement candidates found")
        if minimize is None:
            minimize = target_metric != "throughput"

        filter_metrics = (
            [m for m in ("success", "backpressure") if m in self.models]
            if require_feasible
            else []
        )
        metrics = [target_metric] + [m for m in filter_metrics if m != target_metric]
        if type(self).score_assignments is PlacementOptimizer.score_assignments:
            score = self.estimator.scorer(query, cluster, metrics)
        else:
            # subclass supplies its own scoring (e.g. a simulator oracle in
            # tests); honor the override instead of the hoisted fast path
            score = lambda a: self.score_assignments(query, cluster, a, metrics)
        scores = score(pool)

        worst = np.inf if minimize else -np.inf

        def masked_target() -> np.ndarray:
            feasible = self._feasible_mask(scores, len(pool), filter_metrics)
            return np.where(feasible, scores[target_metric], worst)

        for _ in range(refine_rounds):
            ranked = np.argsort(masked_target())
            if not minimize:
                ranked = ranked[::-1]
            elites = pool[ranked[:refine_top]]
            children = mutate_assignments(query, cluster, elites, refine_mutations, rng)
            # drop children already in the pool (dedup keeps first occurrence)
            children = dedup_assignments(np.concatenate([pool, children]))[len(pool) :]
            if not len(children):
                break
            child_scores = score(children)
            pool = np.concatenate([pool, children])
            scores = {m: np.concatenate([scores[m], child_scores[m]]) for m in metrics}

        feasible = self._feasible_mask(scores, len(pool), filter_metrics)
        masked = masked_target()
        best = int(np.argmin(masked) if minimize else np.argmax(masked))
        preds = {m: float(scores[m][best]) for m in metrics}
        return OptimizerResult(
            placement=Placement.of(pool[best]),
            predicted=preds,
            n_candidates=len(pool),
            n_feasible=int(feasible.sum()),
            candidates=[Placement.of(row) for row in pool],
            scores=scores[target_metric],
        )
