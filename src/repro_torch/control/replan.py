"""Incremental re-placement under a migration-cost budget.

A full re-optimization answers "where would this query run best, from
scratch?" — the wrong question for a *running* query, where every moved
stateful operator drags its window state across the network and eats
downtime.  The re-planner answers the operational question instead: freeze
the operators the detector did NOT implicate, re-enumerate only the affected
sub-assignment, score every candidate through the fused scorer, and accept a
move only when

    predicted steady-state gain  >  hysteresis margin,  and
    state to move                <= migration budget.

Mechanics:

* **Candidates** (``sub_assignment_candidates``): the current assignment
  (always row 0 — the no-op reference), systematic block moves (all free ops
  onto each single host), and ``replan_k`` random redraws of the free
  positions; frozen positions are pinned to their current hosts in every
  row.  Rows are validity-filtered with the Fig.-5 rules as a *search
  prior* — if the filter starves the pool (the running placement may already
  violate bin monotonicity on the residual-capacity cluster), the unfiltered
  pool is used, since the simulator accepts any in-range assignment.

* **Scoring** rides ``CostEstimator.score`` / ``score_many`` — multiple
  affected queries in one tick share ONE merged cross-query forward and the
  estimator's skeleton/merged-group caches, which is what makes re-placement
  latency an SLO the serving stack can meet.  Any callable with the same
  ``(query, cluster, assignments) -> {metric: (N,)}`` shape can stand in
  (tests and the benchmark plug in a noise-free simulator oracle).

* **Migration cost**: moved operators pay their window-state bytes
  (``OpRuntime.state_mb`` — the simulator's own accounting), EXCEPT orphaned
  operators, whose state died with their host; re-homing an orphan is free.
  The chosen move's downtime = restart round-trip + state-bytes over the
  cluster's mean drain bandwidth, charged by the runtime to the next tick.

* **Budget**: candidates over ``migration_budget_mb`` are unselectable; with
  budget 0 only zero-state moves (orphan re-homes) remain and everything
  else degrades to a recorded no-op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dsps.hardware import Cluster
from repro_torch.dsps.query import Query
from repro_torch.placement.enumerate import batch_validity_mask, dedup_assignments

#: Operator redeploy round-trip charged once per accepted migration [s]:
#: stop-the-world rewire of the physical data flow (Storm/Flink rebalance
#: latencies are seconds-scale).
RESTART_S = 2.0

#: Penalty added to predicted cost of candidates the model deems failing /
#: backpressured — large enough to dominate any real latency, finite so a
#: hard item can still pick the least-bad candidate when all fail.
INFEASIBLE_PENALTY = (1e9, 1e6)  # (success < 0.5, backpressure < 0.5)


@dataclass(frozen=True)
class ReplanItem:
    """One affected query handed to the re-planner."""

    query_id: int
    query: Query
    cluster: Cluster  # residual-capacity view to score against
    current: Tuple[int, ...]
    free_ops: Tuple[int, ...]  # ops allowed to move; all others frozen
    state_mb: Tuple[float, ...]  # per-op window-state footprint
    orphaned: Tuple[int, ...] = ()  # ops whose state is already lost
    hard: bool = False  # failure/orphan: hysteresis margin waived


@dataclass(frozen=True)
class MigrationDecision:
    """The per-query outcome of one re-plan round (the decision-log unit)."""

    query_id: int
    action: str  # "migrate" | "accept" | "no-op"
    old: Tuple[int, ...]
    new: Tuple[int, ...]
    moved: Tuple[int, ...]
    migration_mb: float
    downtime_s: float
    predicted_cost: float  # chosen placement, model view
    current_cost: float  # current placement, model view
    gain: float  # relative predicted improvement
    reason: str
    n_candidates: int

    def to_dict(self) -> Dict:
        return {
            "query_id": self.query_id,
            "action": self.action,
            "old": list(self.old),
            "new": list(self.new),
            "moved": list(self.moved),
            "migration_mb": round(self.migration_mb, 6),
            "downtime_s": round(self.downtime_s, 6),
            "predicted_cost": round(self.predicted_cost, 6),
            "current_cost": round(self.current_cost, 6),
            "gain": round(self.gain, 6),
            "reason": self.reason,
            "n_candidates": self.n_candidates,
        }


def sub_assignment_candidates(
    item: ReplanItem, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Candidate matrix with the current assignment at row 0 and only
    ``item.free_ops`` varying in the remaining rows."""
    cur = np.asarray(item.current, dtype=np.int64)
    free = np.asarray(sorted(item.free_ops), dtype=np.int64)
    n_hosts = item.cluster.n_nodes()
    if len(free) == 0 or n_hosts == 0:
        return cur[None, :]
    # systematic block moves: all free ops co-located on each host
    block = np.tile(cur, (n_hosts, 1))
    block[:, free] = np.arange(n_hosts, dtype=np.int64)[:, None]
    # random redraws of the free positions
    rand = np.tile(cur, (max(k, 1), 1))
    rand[:, free] = rng.integers(0, n_hosts, size=(max(k, 1), len(free)))
    pool = np.concatenate([block, rand], axis=0)
    mask = batch_validity_mask(item.query, item.cluster, pool)
    filtered = pool[mask]
    if len(filtered) < 2:
        filtered = pool  # Fig.-5 rules are a prior, not runtime feasibility
    cand = dedup_assignments(filtered)
    cand = cand[~(cand == cur).all(axis=1)][: max(k, 1)]
    return np.concatenate([cur[None, :], cand], axis=0)


class Replanner:
    """Budgeted sub-assignment search over one or many affected queries."""

    def __init__(
        self,
        estimator=None,
        scorer: Optional[Callable] = None,
        target_metric: str = "latency_e",
        metrics: Optional[Sequence[str]] = None,
        budget_mb: float = 64.0,
        replan_k: int = 32,
        min_gain: float = 0.05,
    ):
        assert (estimator is None) != (scorer is None), (
            "exactly one of estimator / scorer"
        )
        self.estimator = estimator
        self._scorer = scorer
        self.target_metric = target_metric
        if metrics is None:
            wanted = (target_metric, "success", "backpressure")
            if estimator is not None:
                metrics = tuple(m for m in wanted if m in estimator.models)
            else:
                metrics = wanted
        assert target_metric in metrics
        self.metrics = tuple(metrics)
        self.budget_mb = float(budget_mb)
        self.replan_k = int(replan_k)
        self.min_gain = float(min_gain)

    # -- scoring -----------------------------------------------------------------

    def _score_all(
        self, items: Sequence[ReplanItem], cands: Sequence[np.ndarray]
    ) -> List[Dict[str, np.ndarray]]:
        if self.estimator is not None:
            reqs = [(it.query, it.cluster, c) for it, c in zip(items, cands)]
            if len(reqs) > 1 and self.estimator.supports_cross_query(self.metrics):
                return self.estimator.score_many(reqs, self.metrics)
            return [self.estimator.score(q, c, a, self.metrics) for q, c, a in reqs]
        return [
            self._scorer(it.query, it.cluster, c) for it, c in zip(items, cands)
        ]

    # -- selection ---------------------------------------------------------------

    def _decide(
        self, item: ReplanItem, cand: np.ndarray, scores: Dict[str, np.ndarray]
    ) -> MigrationDecision:
        cur = np.asarray(item.current, dtype=np.int64)
        state = np.asarray(item.state_mb, dtype=np.float64)
        movable_state = state.copy()
        if item.orphaned:
            movable_state[list(item.orphaned)] = 0.0  # state already lost

        cost = np.asarray(scores[self.target_metric], dtype=np.float64).copy()
        p_fail, p_bp = INFEASIBLE_PENALTY
        if "success" in scores:
            cost = cost + p_fail * (np.asarray(scores["success"]) < 0.5)
        if "backpressure" in scores:
            cost = cost + p_bp * (np.asarray(scores["backpressure"]) < 0.5)

        moved_mask = cand != cur[None, :]
        mig_mb = (moved_mask * movable_state[None, :]).sum(axis=1)
        current_cost = float(cost[0])
        cur_t = tuple(int(x) for x in cur)

        sel_cost = np.where(mig_mb <= self.budget_mb + 1e-9, cost, np.inf)
        sel_cost[0] = current_cost  # the no-op is always selectable
        best = int(np.argmin(sel_cost))
        gain = (current_cost - float(sel_cost[best])) / max(abs(current_cost), 1e-9)

        margin = 0.0 if item.hard else self.min_gain
        if best == 0 or gain <= margin:
            if item.hard:
                # orphaned/failed query whose current (parking) placement
                # re-scored best: formally adopt it as the new home
                return MigrationDecision(
                    query_id=item.query_id, action="accept",
                    old=cur_t, new=cur_t, moved=(),
                    migration_mb=0.0, downtime_s=0.0,
                    predicted_cost=current_cost, current_cost=current_cost,
                    gain=0.0, reason="current placement re-scored best",
                    n_candidates=len(cand),
                )
            best_any = int(np.argmin(cost))
            reason = (
                "over migration budget"
                if best_any != 0 and mig_mb[best_any] > self.budget_mb + 1e-9
                else "gain below hysteresis margin"
            )
            return MigrationDecision(
                query_id=item.query_id, action="no-op",
                old=cur_t, new=cur_t, moved=(),
                migration_mb=0.0, downtime_s=0.0,
                predicted_cost=current_cost, current_cost=current_cost,
                gain=gain, reason=reason, n_candidates=len(cand),
            )

        row = cand[best]
        moved = tuple(int(i) for i in np.where(moved_mask[best])[0])
        mb = float(mig_mb[best])
        drain_mb_s = max(
            float(np.mean([n.bandwidth_mbps for n in item.cluster.nodes])) / 8.0, 1.0
        )
        return MigrationDecision(
            query_id=item.query_id, action="migrate",
            old=cur_t, new=tuple(int(x) for x in row), moved=moved,
            migration_mb=mb, downtime_s=RESTART_S + mb / drain_mb_s,
            predicted_cost=float(cost[best]), current_cost=current_cost,
            gain=gain, reason="predicted gain over budgeted move",
            n_candidates=len(cand),
        )

    def replan_many(
        self, items: Sequence[ReplanItem], seed_key: Tuple[int, ...] = (0,)
    ) -> List[MigrationDecision]:
        """Re-plan every affected query; one merged forward when possible."""
        items = list(items)
        if not items:
            return []
        cands = [
            sub_assignment_candidates(
                it, self.replan_k,
                np.random.default_rng(tuple(seed_key) + (it.query_id, 0xBEE5)),
            )
            for it in items
        ]
        scores = self._score_all(items, cands)
        return [self._decide(it, c, s) for it, c, s in zip(items, cands, scores)]
