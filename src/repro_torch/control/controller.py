"""``PlacementController``: the closed drift -> detect -> re-place loop.

Per tick: pull one ``FleetSnapshot`` from the runtime, update the drift
detector against each query's *predicted-at-placement-time* cost baseline,
turn alarms into ``ReplanItem``s (freezing every operator the alarm did not
implicate), run the budgeted re-planner — one fused scoring pass for ALL
affected queries — and install accepted migrations.  Three mechanisms keep
the loop stable:

* **Hysteresis** — a migration must beat the current placement by
  ``min_gain`` (predicted, relative); hard events (orphans, failed ticks)
  waive it.
* **Cooldown** — a query that just got a decision is held for
  ``replan_cooldown_ticks`` before the detector may trigger it again, so the
  residual spike caused by the migration itself (downtime, new noise
  baseline) cannot re-trigger a move.  Hard events bypass cooldown: an
  orphaned query is never told to wait.
* **Baseline reset** — after a decision the detector re-arms and the
  predicted-cost baseline becomes the re-planner's score for the installed
  placement, so drift is always measured against what the model promised
  *for the placement that is actually running*.

A fourth, optional mechanism handles estimator brown-outs: when a
``degraded`` probe (typically ``lambda: service.stats.degraded``) reports
that scores are coming from the circuit-breaker's heuristic fallback, soft
drift alarms are deferred for that tick — approximate costs keep the fleet
observable but are not trusted to justify migrations — while hard events
(orphans, failed ticks) re-plan regardless.  Ticks taken in this state are
flagged ``TickRecord.degraded``.

Re-placement latency — alarm to chosen migrations, the wall-clock cost of
the scoring machinery — is recorded per re-plan round and reported as
p50/p95/p99 the same way ``serve.load.LoadReport`` reports service latency:
it is an SLO (gated in ``benchmarks/controller_bench.py``), not a debug
number.  Every knob comes from ``DispatchPolicy`` (docs/dispatch.md).

The whole loop is deterministic given (runtime seed, controller seed): the
decision log of ``run()`` replays bit-identically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control.detect import Alarm, DriftDetector
from repro_torch.control.replan import MigrationDecision, ReplanItem, Replanner
from repro_torch.control.telemetry import FleetRuntime, FleetSnapshot
from repro_torch.serve.load import latency_quantiles
from repro_torch.serve.policy import DispatchPolicy, active_policy


@dataclass(frozen=True)
class TickRecord:
    """Everything the controller saw and decided on one tick."""

    tick: int
    fleet_cost_ms: float
    alarms: Tuple[Alarm, ...]
    decisions: Tuple[MigrationDecision, ...]
    replan_latency_s: Optional[float]  # None: no re-plan ran this tick
    degraded: bool = False  # estimator brown-out: soft re-plans deferred

    def n_migrations(self) -> int:
        return sum(1 for d in self.decisions if d.action == "migrate")

    def migrated_mb(self) -> float:
        return float(sum(d.migration_mb for d in self.decisions))


@dataclass
class ControllerReport:
    """Run aggregate: the controller analog of ``serve.load.LoadReport``."""

    n_ticks: int
    records: List[TickRecord]
    final_cost_ms: float  # mean fleet cost over the closing window
    mean_cost_ms: float  # mean fleet cost over the whole run
    n_migrations: int
    n_noops: int
    migrated_mb: float
    max_migration_mb: float  # largest single decision (budget counter-check)
    replan_p50_ms: float
    replan_p95_ms: float
    replan_p99_ms: float
    n_replans: int

    def decision_log(self) -> List[Dict]:
        """Serializable replay log: deterministic for a fixed seed pair."""
        out = []
        for r in self.records:
            for d in r.decisions:
                out.append({"tick": r.tick, **d.to_dict()})
        return out

    def to_dict(self) -> Dict:
        return {
            "n_ticks": self.n_ticks,
            "final_cost_ms": self.final_cost_ms,
            "mean_cost_ms": self.mean_cost_ms,
            "n_migrations": self.n_migrations,
            "n_noops": self.n_noops,
            "migrated_mb": self.migrated_mb,
            "max_migration_mb": self.max_migration_mb,
            "replan_p50_ms": self.replan_p50_ms,
            "replan_p95_ms": self.replan_p95_ms,
            "replan_p99_ms": self.replan_p99_ms,
            "n_replans": self.n_replans,
        }


class PlacementController:
    """Drift-aware incremental re-placement over a ``FleetRuntime``.

    Exactly one of ``estimator`` (a ``CostEstimator`` — the production path,
    riding the fused/merged scorer and its caches) or ``scorer`` (any
    ``(query, cluster, assignments) -> {metric: (N,)}`` callable, e.g. a
    noise-free simulator oracle) provides predictions.  ``replan_every_tick``
    turns the controller into the clairvoyant upper-bound baseline: every
    query re-planned every tick, no cooldown, unbounded budget.
    """

    def __init__(
        self,
        runtime: FleetRuntime,
        estimator=None,
        scorer: Optional[Callable] = None,
        policy: Optional[DispatchPolicy] = None,
        target_metric: str = "latency_e",
        min_gain: float = 0.05,
        seed: int = 0,
        replan_every_tick: bool = False,
        degraded: Optional[Callable[[], bool]] = None,
    ):
        self.runtime = runtime
        #: brown-out probe, e.g. ``lambda: svc.stats.degraded`` — while it
        #: returns True the scorer is answering from the heuristic fallback,
        #: so soft drift alarms are deferred (re-planning on approximate
        #: costs would thrash); hard events (orphans, failures) still re-plan
        self._degraded_probe = degraded
        self.policy = (policy if policy is not None else active_policy()).validate()
        self.seed = int(seed)
        self.replan_every_tick = bool(replan_every_tick)
        budget = np.inf if replan_every_tick else self.policy.migration_budget_mb
        self.replanner = Replanner(
            estimator=estimator,
            scorer=scorer,
            target_metric=target_metric,
            budget_mb=budget,
            replan_k=self.policy.replan_k,
            min_gain=0.0 if replan_every_tick else min_gain,
        )
        self.detector = DriftDetector(
            window=self.policy.detector_window,
            threshold=self.policy.drift_threshold,
        )
        self._pred: Dict[int, float] = {}
        self._cooldown_until: Dict[int, int] = {}
        self.records: List[TickRecord] = []

    # -- scoring helpers ---------------------------------------------------------

    def _score_current(self, qid: int) -> float:
        """Model-predicted cost of the query's current placement — the
        detector baseline recorded at placement time."""
        it = self._item(qid, free_ops=())
        scores = self.replanner._score_all([it], [np.asarray([it.current])])[0]
        return float(scores[self.replanner.target_metric][0])

    def _item(self, qid: int, free_ops: Sequence[int], hard: bool = False) -> ReplanItem:
        rt = self.runtime
        return ReplanItem(
            query_id=qid,
            query=rt.query(qid),
            cluster=rt.observed_cluster(qid),
            current=tuple(int(x) for x in rt.assignment(qid)),
            free_ops=tuple(sorted(set(int(o) for o in free_ops))),
            state_mb=tuple(float(x) for x in rt.state_mb(qid)),
            orphaned=rt.orphans(qid),
            hard=hard,
        )

    # -- alarm -> replan item ----------------------------------------------------

    def _items_from_alarms(self, snap: FleetSnapshot, alarms: Sequence[Alarm]):
        by_query: Dict[int, Alarm] = {}
        for a in alarms:
            prev = by_query.get(a.query_id)
            if prev is None or (a.hard() and not prev.hard()):
                by_query[a.query_id] = a
        items: List[ReplanItem] = []
        for qid, a in sorted(by_query.items()):
            if not a.hard() and snap.tick < self._cooldown_until.get(qid, 0):
                continue  # cooling down; hard events never wait
            assign = self.runtime.assignment(qid)
            orphans = set(self.runtime.orphans(qid))
            on_hot = {i for i, h in enumerate(assign) if int(h) in set(a.hot_hosts)}
            free = orphans | on_hot
            if not free:
                free = set(range(len(assign)))  # whole query implicated
            items.append(self._item(qid, free, hard=a.hard()))
        return items

    # -- the loop ----------------------------------------------------------------

    def step(self) -> TickRecord:
        snap = self.runtime.tick()
        for qid in self.runtime.query_ids:
            if qid not in self._pred:
                self._pred[qid] = self._score_current(qid)
        alarms = self.detector.update(snap, self._pred)

        degraded = bool(self._degraded_probe()) if self._degraded_probe is not None else False
        if self.replan_every_tick:
            items = [
                self._item(qid, range(self.runtime.query(qid).n_ops()), hard=True)
                for qid in self.runtime.query_ids
            ]
        else:
            items = self._items_from_alarms(snap, alarms)
            if degraded:
                # the estimator is browned out: its scores are heuristic
                # fallbacks, good enough to keep serving but not to justify
                # migrations.  Defer drift-triggered moves until it recovers;
                # orphaned/failed queries cannot wait and re-plan anyway.
                items = [it for it in items if it.hard]

        decisions: Tuple[MigrationDecision, ...] = ()
        latency: Optional[float] = None
        if items:
            t0 = time.perf_counter()
            decisions = tuple(
                self.replanner.replan_many(items, seed_key=(self.seed, snap.tick))
            )
            latency = time.perf_counter() - t0
            for d in decisions:
                if d.action == "migrate":
                    self.runtime.apply(d.query_id, d.new, d.downtime_s)
                elif d.action == "accept":
                    self.runtime.adopt(d.query_id)
                # every decision re-arms the detector against the placement
                # the model just (re-)endorsed
                self._pred[d.query_id] = d.predicted_cost
                self.detector.reset(d.query_id)
                self._cooldown_until[d.query_id] = (
                    snap.tick + 1 + self.policy.replan_cooldown_ticks
                )

        rec = TickRecord(
            tick=snap.tick,
            fleet_cost_ms=snap.fleet_cost_ms(),
            alarms=tuple(alarms),
            decisions=decisions,
            replan_latency_s=latency,
            degraded=degraded,
        )
        self.records.append(rec)
        return rec

    def run(self, n_ticks: int, closing_window: Optional[int] = None) -> ControllerReport:
        for _ in range(n_ticks):
            self.step()
        return self.report(closing_window)

    def report(self, closing_window: Optional[int] = None) -> ControllerReport:
        recs = self.records
        costs = [r.fleet_cost_ms for r in recs]
        w = closing_window if closing_window is not None else max(1, len(recs) // 5)
        lat = [r.replan_latency_s for r in recs if r.replan_latency_s is not None]
        p50, p95, p99 = latency_quantiles(lat) if lat else (0.0, 0.0, 0.0)
        return ControllerReport(
            n_ticks=len(recs),
            records=list(recs),
            final_cost_ms=float(np.mean(costs[-w:])) if costs else 0.0,
            mean_cost_ms=float(np.mean(costs)) if costs else 0.0,
            n_migrations=sum(r.n_migrations() for r in recs),
            n_noops=sum(
                1 for r in recs for d in r.decisions if d.action == "no-op"
            ),
            migrated_mb=float(sum(r.migrated_mb() for r in recs)),
            max_migration_mb=float(
                max((d.migration_mb for r in recs for d in r.decisions), default=0.0)
            ),
            replan_p50_ms=p50 * 1e3,
            replan_p95_ms=p95 * 1e3,
            replan_p99_ms=p99 * 1e3,
            n_replans=len(lat),
        )


def run_static(runtime: FleetRuntime, n_ticks: int, closing_window: Optional[int] = None) -> ControllerReport:
    """The do-nothing baseline: tick the fleet, never re-place anything."""
    records = []
    for _ in range(n_ticks):
        snap = runtime.tick()
        records.append(
            TickRecord(
                tick=snap.tick,
                fleet_cost_ms=snap.fleet_cost_ms(),
                alarms=(),
                decisions=(),
                replan_latency_s=None,
            )
        )
    costs = [r.fleet_cost_ms for r in records]
    w = closing_window if closing_window is not None else max(1, len(records) // 5)
    return ControllerReport(
        n_ticks=len(records),
        records=records,
        final_cost_ms=float(np.mean(costs[-w:])) if costs else 0.0,
        mean_cost_ms=float(np.mean(costs)) if costs else 0.0,
        n_migrations=0,
        n_noops=0,
        migrated_mb=0.0,
        max_migration_mb=0.0,
        replan_p50_ms=0.0,
        replan_p95_ms=0.0,
        replan_p99_ms=0.0,
        n_replans=0,
    )
