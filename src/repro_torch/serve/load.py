"""Open-loop load generation for ``PlacementService``: the serving-path SLO
instrumentation (the port of ``repro/serve/load.py``).

Closed-loop benchmarks (``benchmarks/serve_bench.py``) measure *drain
throughput*: the next request waits for the previous answer, so the system is
never pressured beyond its own pace.  A production estimator serving many
concurrent users sees an **open-loop** arrival process — requests arrive on
the *clients'* schedule whether or not the service keeps up — and is judged
on tail latency (p95/p99) and SLO violations, not on drain rate.  This
module generates seeded, deterministic arrival schedules (Poisson and
bursty), replays them against a service, and reduces the per-request
latencies to the quantities that matter:

* per-request latency measured from the request's *scheduled* arrival to its
  answer (so driver lag and queueing both count, the open-loop convention);
* p50/p95/p99 latency and the SLO-violation rate at a given threshold;
* the saturation knee over a rate sweep: the highest offered rate whose p95
  stays within budget (``find_knee``).

Schedules are pure functions of (rate, horizon, seed): re-running a
configuration replays the identical request sequence, so harness runs are
comparable across service configurations and across commits.
``benchmarks/load_harness.py`` is the CLI; docs/load_harness.md the
methodology reference.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.service import PlacementService, ServiceOverloadError, ServiceStats

#: Latency quantiles every report carries, in ascending order.
QUANTILES = (50.0, 95.0, 99.0)


# -- arrival schedules ------------------------------------------------------------


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds) of a Poisson process at ``rate`` req/s.

    Exponential i.i.d. inter-arrival gaps from a seeded generator: the
    memoryless process every open-loop serving benchmark defaults to.
    Deterministic in (rate, n, seed).
    """
    assert rate > 0 and n > 0, (rate, n)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def bursty_arrivals(
    rate: float,
    n: int,
    seed: int = 0,
    burst_factor: float = 8.0,
    burst_fraction: float = 0.2,
    period_s: float = 1.0,
) -> np.ndarray:
    """Arrival offsets of a two-phase on/off process averaging ``rate`` req/s.

    Each ``period_s`` window splits into a burst phase (``burst_fraction`` of
    the period at ``burst_factor`` x the base intensity) and a quiet phase
    (the remaining time at the complementary intensity, so the long-run mean
    stays ``rate``).  Models synchronized client behavior — monitoring rounds
    firing together, retry storms — which stresses queueing far harder than
    Poisson at the same mean rate.  Deterministic in all arguments.
    """
    assert rate > 0 and n > 0, (rate, n)
    assert 0.0 < burst_fraction < 1.0, burst_fraction
    assert burst_factor >= 1.0, burst_factor
    burst_rate = rate * burst_factor
    quiet_weight = 1.0 - burst_factor * burst_fraction
    if quiet_weight <= 0:  # all mass in the burst: quiet phase silent
        burst_rate = rate / burst_fraction
        quiet_rate = 0.0
    else:
        quiet_rate = rate * quiet_weight / (1.0 - burst_fraction)
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        burst_end = t + burst_fraction * period_s
        period_end = t + period_s
        cursor = t
        while True:  # burst phase: dense exponential gaps
            cursor += rng.exponential(1.0 / burst_rate)
            if cursor >= burst_end or len(out) >= n:
                break
            out.append(cursor)
        cursor = burst_end
        if quiet_rate > 0:
            while True:
                cursor += rng.exponential(1.0 / quiet_rate)
                if cursor >= period_end or len(out) >= n:
                    break
                out.append(cursor)
        t = period_end
    return np.asarray(out[:n])


# -- running one open-loop experiment ---------------------------------------------


@dataclass
class LoadReport:
    """One open-loop run reduced to its serving-quality numbers.

    ``latencies_s`` holds one entry per *answered* request, aligned with the
    arrival schedule order with rejected/failed requests removed; latency is
    measured from the request's scheduled arrival time (not the possibly-late
    submit), so queueing delay, driver lag, and service time all count —
    the number a client would experience.
    """

    n_requests: int
    n_answered: int
    n_rejected: int
    n_failed: int
    duration_s: float
    offered_rate: float  # requests/s the schedule asked for
    achieved_rate: float  # answered requests/s actually delivered
    latencies_s: np.ndarray
    p50_s: float
    p95_s: float
    p99_s: float
    slo_s: Optional[float]
    n_slo_violations: int  # answered-but-late plus rejected/failed requests
    slo_violation_rate: float
    stats: ServiceStats = field(default_factory=ServiceStats)

    def summary(self) -> Dict[str, float]:
        """The scalar subset, JSON-ready (for benchmark baselines)."""
        return {
            "n_requests": self.n_requests,
            "n_answered": self.n_answered,
            "n_rejected": self.n_rejected,
            "n_failed": self.n_failed,
            "duration_s": round(self.duration_s, 4),
            "offered_rps": round(self.offered_rate, 2),
            "achieved_rps": round(self.achieved_rate, 2),
            "p50_ms": round(self.p50_s * 1e3, 3),
            "p95_ms": round(self.p95_s * 1e3, 3),
            "p99_ms": round(self.p99_s * 1e3, 3),
            "slo_violation_rate": round(self.slo_violation_rate, 4),
            "max_queue_depth": self.stats.max_queue_depth,
            "max_drain": self.stats.max_drain,
            "mean_queue_wait_ms": round(
                (self.stats.queue_wait_s / max(1, self.stats.n_drained)) * 1e3, 3
            ),
        }


def latency_quantiles(latencies_s: Sequence[float]) -> Tuple[float, float, float]:
    """(p50, p95, p99) of a latency sample; NaNs when the sample is empty."""
    lat = np.asarray(latencies_s, dtype=np.float64)
    if lat.size == 0:
        return (float("nan"),) * 3
    p50, p95, p99 = np.percentile(lat, QUANTILES)
    return float(p50), float(p95), float(p99)


def run_open_loop(
    service: PlacementService,
    submit_fns: Sequence[Callable[[], "object"]],
    arrivals_s: np.ndarray,
    slo_s: Optional[float] = None,
    timeout_s: float = 120.0,
) -> LoadReport:
    """Replay ``submit_fns[i]`` at ``arrivals_s[i]`` against a started service.

    The driver thread sleeps to each scheduled arrival and fires the submit
    WITHOUT waiting for the answer (open loop: a slow service does not slow
    the clients down); completion times are captured by future callbacks.  A
    submit that raises ``ServiceOverloadError`` counts as rejected (and as an
    SLO violation — the client got no answer); any other per-request failure
    counts as failed.  Latency for answered requests is
    ``completion - scheduled_arrival``.
    """
    n = len(arrivals_s)
    assert n == len(submit_fns), (n, len(submit_fns))
    done_at = np.full(n, np.nan)
    failed = np.zeros(n, dtype=bool)
    rejected = np.zeros(n, dtype=bool)
    outstanding = threading.Semaphore(0)

    def _on_done(i: int, t0: float):
        def cb(fut):
            done_at[i] = time.perf_counter() - t0
            if fut.exception() is not None:
                failed[i] = True
            outstanding.release()

        return cb

    t0 = time.perf_counter()
    for i, (at, fire) in enumerate(zip(arrivals_s, submit_fns)):
        lag = at - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        try:
            fut = fire()
        except ServiceOverloadError:
            rejected[i] = True
            outstanding.release()
            continue
        fut.add_done_callback(_on_done(i, t0))
    deadline = time.perf_counter() + timeout_s
    for _ in range(n):
        if not outstanding.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            raise TimeoutError(
                f"open-loop run did not resolve all {n} requests within {timeout_s}s"
            )
    duration = time.perf_counter() - t0

    answered = ~rejected & ~failed
    latencies = (done_at - np.asarray(arrivals_s))[answered]
    p50, p95, p99 = latency_quantiles(latencies)
    n_answered = int(answered.sum())
    if slo_s is not None:
        n_viol = int((latencies > slo_s).sum()) + int(rejected.sum()) + int(failed.sum())
    else:
        n_viol = 0
    return LoadReport(
        n_requests=n,
        n_answered=n_answered,
        n_rejected=int(rejected.sum()),
        n_failed=int(failed.sum()),
        duration_s=duration,
        offered_rate=n / float(arrivals_s[-1]) if n else 0.0,
        achieved_rate=n_answered / duration if duration > 0 else 0.0,
        latencies_s=latencies,
        p50_s=p50,
        p95_s=p95,
        p99_s=p99,
        slo_s=slo_s,
        n_slo_violations=n_viol,
        slo_violation_rate=n_viol / n if n else 0.0,
        stats=ServiceStats(**vars(service.stats)),  # snapshot: stats keep mutating
    )


def score_request_stream(
    structures: Sequence[Tuple],
    n_requests: int,
    cands_per_request: int,
    seed: int = 0,
    metrics: Optional[Sequence[str]] = None,
) -> Callable[[PlacementService], List[Callable]]:
    """Submit thunks for a mixed score stream round-robining ``structures``.

    Request i targets structure ``i % len(structures)`` with a seeded
    candidate matrix — the heterogeneous many-small-queries mix the
    cross-query serving path exists for.  Returns a factory so the same
    deterministic stream can be replayed against several services.
    """
    from repro_torch.placement.enumerate import sample_assignment_matrix

    rng = np.random.default_rng(seed)
    payloads = []
    for i in range(n_requests):
        q, c = structures[i % len(structures)]
        payloads.append((q, c, sample_assignment_matrix(q, c, cands_per_request, rng)))

    def bind(service: PlacementService) -> List[Callable]:
        return [
            (lambda q=q, c=c, a=a: service.submit_score(q, c, a, metrics))
            for q, c, a in payloads
        ]

    return bind


# -- saturation knee --------------------------------------------------------------


@dataclass
class KneePoint:
    rate: float
    p95_s: float
    slo_violation_rate: float


def find_knee(
    run_at_rate: Callable[[float], LoadReport],
    rates: Sequence[float],
    slo_s: float,
) -> Tuple[Optional[float], List[KneePoint]]:
    """Sweep offered rates ascending; return (knee, per-rate points).

    The knee is the highest offered rate whose p95 latency stays within
    ``slo_s`` AND whose SLO-violation rate stays under 1% — the last
    sustainable operating point before queueing takes over.  ``None`` when
    even the lowest rate violates (the service is saturated everywhere in
    the sweep).  The sweep early-exits two rates past the knee: beyond
    saturation, open-loop p95 grows with run length, not with the service,
    so further points cost time and prove nothing.
    """
    knee = None
    points: List[KneePoint] = []
    over = 0
    for rate in sorted(rates):
        rep = run_at_rate(rate)
        points.append(KneePoint(rate, rep.p95_s, rep.slo_violation_rate))
        if rep.p95_s <= slo_s and rep.slo_violation_rate < 0.01:
            knee = rate
            over = 0
        else:
            over += 1
            if over >= 2:
                break
    return knee, points
