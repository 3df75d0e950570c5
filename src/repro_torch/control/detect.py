"""Drift and degradation detectors over fleet telemetry windows.

The controller's question every tick is not "is something wrong?" but
"*which queries* need re-placement, and which hosts should their operators
avoid?".  Two signal classes answer it:

* **Soft drift** — per-query sequential tests on the residual

      r_t = log(observed_cost_t / predicted_cost)

  where ``predicted_cost`` is the cost-model estimate *recorded when the
  current placement was chosen* (re-placement resets it).  Under no drift the
  residual is the simulator's log-normal measurement noise around the model's
  (constant) bias; under drift it acquires a sustained positive mean.  An
  EWMA (span = ``detector_window``) tracks the level for reporting, and a
  one-sided CUSUM ``s_t = max(0, s_{t-1} + r_t - k)`` with slack ``k``
  accumulates evidence; ``s_t > drift_threshold`` after at least
  ``detector_window`` samples raises a drift alarm.  CUSUM + window arm, not
  a single-sample threshold: one noisy tick cannot fire it, a modest but
  sustained shift cannot hide from it.

* **Hard events** — no statistics needed: orphaned operators (the query is
  running on a failover parking host), evictions, straggler flags from the
  ``ClusterMonitor``, and outright failed ticks (success = 0) alarm
  immediately, bypassing the window.

Alarms also *localize hosts*: hosts whose fleet utilization exceeds
``HOT_HOST_UTIL`` (plus freshly flagged stragglers) are reported as hosts the
re-planner should move work away from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control.telemetry import FleetSnapshot

#: Hosts above this fleet cpu utilization are reported "hot" in alarms: past
#: ~0.8 the simulator's M/M/1 waits grow super-linearly, so a replan should
#: treat the host as effectively full even before hard backpressure at 1.0.
HOT_HOST_UTIL = 0.8

#: CUSUM slack as a multiple of the simulator's measurement-noise sigma
#: (0.12): drifts smaller than ~2 sigma per tick are treated as noise floor.
CUSUM_SLACK = 0.25


@dataclass(frozen=True)
class Alarm:
    """One localized detection: which query, why, and which hosts to avoid."""

    tick: int
    query_id: int
    kind: str  # "drift" | "failed" | "orphaned" | "straggler" | "evicted"
    score: float  # CUSUM level (drift) or residual (hard events)
    hot_hosts: Tuple[int, ...] = ()  # current host indices to move away from

    def hard(self) -> bool:
        return self.kind != "drift"


@dataclass
class _QueryTrack:
    ewma: float = 0.0
    cusum: float = 0.0
    n: int = 0


class DriftDetector:
    """Per-query EWMA/CUSUM drift tracking + hard-event pass-through."""

    def __init__(self, window: int, threshold: float, slack: float = CUSUM_SLACK):
        assert window >= 1 and threshold > 0
        self.window = int(window)
        self.threshold = float(threshold)
        self.slack = float(slack)
        self._tracks: Dict[int, _QueryTrack] = {}

    def reset(self, query_id: int) -> None:
        """Re-arm after a re-placement: the residual baseline changed."""
        self._tracks[query_id] = _QueryTrack()

    def level(self, query_id: int) -> float:
        """Current EWMA residual — the recorded degradation of a query."""
        return self._tracks.get(query_id, _QueryTrack()).ewma

    def update(
        self, snapshot: FleetSnapshot, predicted_cost_ms: Dict[int, float]
    ) -> List[Alarm]:
        """Consume one tick of telemetry; return localized alarms.

        ``predicted_cost_ms`` maps query_id -> the cost predicted for the
        query's *current* placement when that placement was installed.
        """
        alarms: List[Alarm] = []
        alpha = 2.0 / (self.window + 1.0)
        flagged = {sid for sid, _ in snapshot.flagged}
        hot = tuple(
            h.index
            for h in snapshot.hosts
            if h.util >= HOT_HOST_UTIL or h.stable_id in flagged
        )
        for qid, obs in sorted(snapshot.queries.items()):
            tr = self._tracks.setdefault(qid, _QueryTrack())
            pred = max(float(predicted_cost_ms.get(qid, obs.cost_ms)), 1e-6)
            r = float(np.log(max(obs.cost_ms, 1e-6) / pred))
            tr.n += 1
            tr.ewma = r if tr.n == 1 else (1 - alpha) * tr.ewma + alpha * r
            tr.cusum = max(0.0, tr.cusum + r - self.slack)

            # hard events first: they bypass the window entirely
            if obs.orphaned:
                alarms.append(Alarm(snapshot.tick, qid, "orphaned", r, hot))
                continue
            if not obs.labels.success:
                alarms.append(Alarm(snapshot.tick, qid, "failed", r, hot))
                continue
            host_set = set(obs.assignment)
            if flagged and any(
                h.index in host_set for h in snapshot.hosts if h.stable_id in flagged
            ):
                alarms.append(Alarm(snapshot.tick, qid, "straggler", r, hot))
                continue
            if tr.n >= self.window and tr.cusum > self.threshold:
                alarms.append(Alarm(snapshot.tick, qid, "drift", tr.cusum, hot))
        return alarms
