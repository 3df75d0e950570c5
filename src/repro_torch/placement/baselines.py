"""Online-monitoring rescheduling baseline (paper Exp 2b, after [1, 11]).

Storm-style adaptive scheduling: start from the heuristic placement, monitor
runtime statistics (here: the simulator's host utilizations), and migrate the
most loaded operator to a stronger/less-utilized host every monitoring
interval, paying a migration overhead. We report (a) the initial slow-down
vs. the COSTREAM-chosen placement and (b) the *monitoring overhead*: the time
until the rescheduler reaches a placement competitive with COSTREAM's initial
one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.dsps.hardware import Cluster, hardware_bin
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import OpType, Query
from repro_torch.dsps.simulator import SimulatorConfig, analyze_operators, simulate, _dtype_mix


@dataclass
class MonitoringResult:
    initial_latency: float  # L_p of the heuristic initial placement
    final_latency: float
    target_latency: float  # L_p of the COSTREAM placement to beat
    steps: List[float]  # L_p after each monitoring round
    overhead_seconds: float  # time until competitive (inf if never)
    migrations: int


def _host_utilizations(query: Query, cluster: Cluster, placement: Placement) -> np.ndarray:
    """Monitoring signal: per-host CPU utilization (what Storm exposes)."""
    rt = analyze_operators(query, _dtype_mix(query))
    load = np.zeros(cluster.n_nodes())
    for op in query.operators:
        n = placement.node_of(op.op_id)
        load[n] += rt[op.op_id].rate_in * rt[op.op_id].service_ms / 1e3
    caps = np.array([node.cores() for node in cluster.nodes])
    return load / np.maximum(caps, 1e-9)


def online_monitoring_run(
    query: Query,
    cluster: Cluster,
    initial: Placement,
    target_latency: float,
    monitor_interval_s: float = 30.0,
    migration_cost_s: float = 12.0,
    max_rounds: int = 12,
    sim: SimulatorConfig = SimulatorConfig(),
    rng: Optional[np.random.Generator] = None,
) -> MonitoringResult:
    rng = rng or np.random.default_rng(0)
    placement = initial
    labels = simulate(query, cluster, placement, sim, rng=rng)
    initial_latency = labels.latency_p
    lat = initial_latency
    steps = [lat]
    elapsed = monitor_interval_s  # first stats need one interval to stabilize
    migrations = 0
    overhead = np.inf if lat > target_latency else 0.0

    for _ in range(max_rounds):
        if lat <= target_latency:
            overhead = min(overhead, elapsed)
            break
        util = _host_utilizations(query, cluster, placement)
        hot = int(np.argmax(util))
        ops_on_hot = [i for i in range(query.n_ops()) if placement.node_of(i) == hot]
        movable = [i for i in ops_on_hot if query.op(i).op_type != OpType.SOURCE]
        if not movable:
            elapsed += monitor_interval_s
            continue
        # move the heaviest movable operator to the least-utilized stronger host
        bins = cluster.bins()
        order = np.argsort(util)
        dest = None
        for cand in order:
            if cand != hot and bins[int(cand)] >= bins[hot]:
                dest = int(cand)
                break
        if dest is None:
            dest = int(order[0])
        victim = movable[-1]
        assign = list(placement.assignment)
        assign[victim] = dest
        placement = Placement.of(assign)
        migrations += 1
        elapsed += monitor_interval_s + migration_cost_s
        labels = simulate(query, cluster, placement, sim, rng=rng)
        lat = labels.latency_p
        steps.append(lat)
        if lat <= target_latency:
            overhead = min(overhead, elapsed)
            break

    return MonitoringResult(
        initial_latency=initial_latency,
        final_latency=lat,
        target_latency=target_latency,
        steps=steps,
        overhead_seconds=float(overhead),
        migrations=migrations,
    )
