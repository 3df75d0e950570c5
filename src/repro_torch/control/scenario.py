"""The canonical drift+failure scenario (benchmark, demo, and doc example).

A deliberately bottom-heavy edge cluster and a fleet of placement-sensitive
queries, calibrated so the scripted events actually bite: an x8 rate drift
saturates whatever host the fleet leans on, and the failed host is the
strongest one — the host the contention-aware initial planner piles onto.
``benchmarks/controller_bench.py`` gates controller behavior on it;
``examples/controller_demo.py`` narrates it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.control.telemetry import ScenarioEvent, SimulatorScorer, plan_initial_fleet
from repro_torch.dsps.generator import WorkloadGenerator
from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.dsps.query import Query


def weak_cluster() -> Cluster:
    """Six hosts spanning the corpus hardware range, deliberately bottom-heavy
    (cpu 100-400 of the corpus' 50-800) so an x8 rate drift saturates whatever
    host the fleet leans on.  Host 3 is the strongest — the oracle initial
    placement piles onto it, which is exactly what the scripted failure
    kills."""
    specs = [
        (300, 8000, 400, 5),
        (200, 4000, 200, 10),
        (150, 4000, 100, 10),
        (400, 16000, 800, 2),
        (100, 2000, 50, 20),
        (300, 8000, 400, 5),
    ]
    return Cluster([HardwareNode(i, *s) for i, s in enumerate(specs)])


def fleet_queries(cluster: Cluster, n: int, seed: int = 7) -> List[Query]:
    """``n`` placement-sensitive linear queries: high event rate (>= 1600/s,
    so drift has teeth) and an achievable sub-100ms e2e latency on this
    cluster (so fleet cost reflects placement, not window waits)."""
    from repro_torch.placement.enumerate import sample_assignment_matrix

    gen = WorkloadGenerator(seed=seed)
    scorer = SimulatorScorer()
    out: List[Query] = []
    i = 0
    while len(out) < n and i < 40 * n:
        q = gen.query(kind="linear", name=f"fleet{i}")
        i += 1
        cand = sample_assignment_matrix(q, cluster, 32, np.random.default_rng(i))
        if not len(cand):
            continue
        s = scorer(q, cluster, cand)
        best = float(np.min(s["latency_e"] + 1e9 * (s["success"] < 0.5)))
        rate = max(op.event_rate for op in q.operators)
        if best < 100.0 and rate >= 1600:
            out.append(q)
    if len(out) < n:
        raise RuntimeError(f"only {len(out)}/{n} scenario queries found")
    return out


def build_scenario(
    n_queries: int, n_ticks: int, seed: int = 7
) -> Tuple[List[Tuple[Query, Tuple[int, ...]]], Cluster, List[ScenarioEvent]]:
    """The frozen drift+failure scenario; returns (fleet, cluster, events)."""
    cluster = weak_cluster()
    queries = fleet_queries(cluster, n_queries, seed=seed)
    fleet = plan_initial_fleet(queries, cluster, k=64, seed=3)
    drift_at = max(4, n_ticks // 5)
    fail_at = n_ticks // 2
    join_at = (3 * n_ticks) // 4
    events = [
        ScenarioEvent(tick=drift_at, kind="rate_drift", query=0, factor=8.0),
        ScenarioEvent(tick=drift_at + 1, kind="rate_drift", query=1, factor=8.0),
        ScenarioEvent(tick=fail_at, kind="fail", host=3),
        ScenarioEvent(
            tick=join_at, kind="join", node=HardwareNode(0, 500, 16000, 1600, 2)
        ),
    ]
    return fleet, cluster, events
