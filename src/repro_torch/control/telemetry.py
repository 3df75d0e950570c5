"""``FleetRuntime``: simulated telemetry for a fleet of co-located queries.

The cost simulator (``dsps/simulator.py``) is the repo's ground-truth oracle
for ONE placed query on ONE cluster.  The continuous-placement scenario
(ROADMAP: drift, failure, elastic re-placement) needs the *fleet* view: N
queries sharing the same hosts, conditions changing over time.  This module
wraps the simulator as that oracle:

* **Ticks.**  Simulated time advances in ``controller_tick_s`` steps; each
  tick applies scheduled scenario events, drives the heartbeat/straggler
  monitor (``launch/faults.py``), and emits one ``FleetSnapshot`` of
  per-query observed costs and per-host utilization.

* **Contention.**  Co-located queries share hosts.  Each query is simulated
  against its *residual-capacity* view of the cluster: every host's cpu/ram
  reduced by the analytic load/state the OTHER queries place on it (the same
  ``analyze_operators`` quantities the simulator itself uses).  This is what
  a metrics backend would report as free capacity per host — so the
  controller may legitimately score candidates against the same view
  (``observed_cluster``).

* **Scenario events** (``ScenarioEvent``): tuple-rate drift and selectivity
  drift rebuild the affected query's operators (telemetry observes the new
  rates — the drifted query IS the current truth); ``fail`` stops a host's
  heartbeats so the ``ClusterMonitor`` evicts it on timeout (surviving hosts
  are renumbered, every placement remapped, operators stranded on the dead
  host parked as *orphans* on the lowest-numbered survivor); ``straggle``
  slows a host; ``join`` adds capacity.

* **Migrations** are applied through ``apply``: the new assignment takes
  effect next tick and the migration's downtime is charged to that tick's
  observed cost (throughput scaled down, latency_e inflated) — transition
  pain is real, not free.

Everything is seeded: the measurement-noise stream is derived from
``(seed, tick, query_id)``, so the same scenario replays bit-identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import OpType, Query
from repro_torch.dsps.simulator import (
    JVM_BASE_MB,
    MEASUREMENT_S,
    CostLabels,
    SimulatorConfig,
    _dtype_mix,
    analyze_operators,
    simulate,
)
from repro_torch.launch.faults import ClusterMonitor, FaultPolicy, VirtualHost
from repro_torch.serve.policy import DispatchPolicy, active_policy

#: Observed cost charged to a query whose tick failed (success = 0): the
#: worst-case broker backlog the simulator itself can produce — half the
#: 4-minute measurement interval of queued wait (paper Def. 4/5).
FAIL_COST_MS = 0.5 * MEASUREMENT_S * 1e3

#: Residual-capacity floors: a fully contended host still exposes a sliver of
#: capacity instead of a degenerate zero-cpu node.
MIN_RESIDUAL_CPU = 5.0
MIN_RESIDUAL_RAM_MB = JVM_BASE_MB + 64.0

#: Heartbeat timeout in ticks: one missed tick is noise (a long GC pause),
#: two is a dead host — the standard 1.5x monitoring-interval rule.
HEARTBEAT_TIMEOUT_TICKS = 1.5

#: Per-step wall time a healthy host reports to the straggler detector; only
#: ratios matter (the detector is a median/MAD outlier test).
BASE_STEP_S = 0.1


@dataclass(frozen=True)
class ScenarioEvent:
    """One scheduled condition change, applied when the runtime reaches
    ``tick``.  ``kind``:

    - ``"rate_drift"``: multiply ``query``'s source event rates by ``factor``
    - ``"selectivity_drift"``: multiply ``query``'s filter/join/agg
      selectivities by ``factor`` (clipped to (0.01, 1])
    - ``"fail"``: host ``host`` (stable id) stops heartbeating; evicted by
      the monitor one timeout later
    - ``"straggle"``: host ``host`` slows by ``factor`` (cpu / factor)
    - ``"join"``: a new host joins with ``node``'s features
    """

    tick: int
    kind: str
    query: Optional[int] = None
    host: Optional[int] = None
    factor: float = 1.0
    node: Optional[HardwareNode] = None

    def __post_init__(self):
        assert self.kind in (
            "rate_drift", "selectivity_drift", "fail", "straggle", "join",
        ), self.kind


@dataclass(frozen=True)
class QueryObs:
    """One query's observed telemetry for one tick."""

    query_id: int
    labels: CostLabels
    cost_ms: float  # scalar fleet-cost contribution (latency_e or FAIL_COST_MS)
    assignment: Tuple[int, ...]  # current host indices (post-remap)
    orphaned: Tuple[int, ...]  # ops parked on the failover host
    downtime_s: float  # migration downtime charged to this tick


@dataclass(frozen=True)
class HostObs:
    index: int  # current cluster index (contiguous)
    stable_id: int  # scenario-stable id (survives renumbering)
    util: float  # fleet cpu load / capacity
    state_mb: float  # fleet window state resident
    straggle: float  # >1 = slowed


@dataclass(frozen=True)
class FleetSnapshot:
    tick: int
    time_s: float
    queries: Dict[int, QueryObs]
    hosts: Tuple[HostObs, ...]
    evicted: Tuple[Tuple[int, str], ...]  # (stable_id, reason) this tick
    flagged: Tuple[Tuple[int, str], ...]  # straggler flags this tick
    joined: Tuple[int, ...]  # stable ids of hosts that joined this tick

    def fleet_cost_ms(self) -> float:
        """Mean per-query observed cost — the end-of-run gate metric."""
        if not self.queries:
            return 0.0
        return float(np.mean([q.cost_ms for q in self.queries.values()]))


class FleetRuntime:
    """Ground-truth oracle for N co-located queries under scenario events."""

    def __init__(
        self,
        queries: Sequence[Tuple[Query, Sequence[int]]],
        cluster: Cluster,
        events: Sequence[ScenarioEvent] = (),
        seed: int = 0,
        tick_s: Optional[float] = None,
        sim_config: Optional[SimulatorConfig] = None,
        policy: Optional[DispatchPolicy] = None,
    ):
        policy = policy if policy is not None else active_policy()
        self.tick_s = float(tick_s if tick_s is not None else policy.controller_tick_s)
        self.seed = int(seed)
        self.sim_config = sim_config if sim_config is not None else SimulatorConfig()
        self.events = sorted(events, key=lambda e: e.tick)
        self.cluster = Cluster(nodes=list(cluster.nodes))
        # own private operator instances: drift rebuilds operators and
        # infer_widths mutates them in place — never the caller's objects
        self._queries: Dict[int, Query] = {
            i: self._own(q) for i, (q, _) in enumerate(queries)
        }
        self._assign: Dict[int, np.ndarray] = {}
        for i, (q, a) in enumerate(queries):
            a = np.asarray(a, dtype=np.int64)
            Placement.of(a).validate(self._queries[i], cluster)
            self._assign[i] = a.copy()
        self._orphans: Dict[int, set] = {i: set() for i in self._queries}
        self._downtime: Dict[int, float] = {i: 0.0 for i in self._queries}
        # stable host ids: scenario events address hosts by the id they had
        # at fleet start; renumbering after an eviction preserves the mapping
        self._stable_ids: List[int] = [n.node_id for n in cluster.nodes]
        self._next_stable = len(cluster.nodes)
        self._dead: set = set()
        self._straggle: Dict[int, float] = {}
        self.monitor = ClusterMonitor(
            n_hosts=cluster.n_nodes(),
            policy=FaultPolicy(heartbeat_timeout_s=HEARTBEAT_TIMEOUT_TICKS * self.tick_s),
        )
        self.tick_idx = 0
        self.time_s = 0.0
        for sid in self._stable_ids:
            self.monitor.heartbeat(sid, 0.0)

    # -- views -------------------------------------------------------------------

    @property
    def query_ids(self) -> List[int]:
        return sorted(self._queries)

    def query(self, query_id: int) -> Query:
        """The query as telemetry currently observes it (drift included)."""
        return self._queries[query_id]

    def assignment(self, query_id: int) -> np.ndarray:
        return self._assign[query_id].copy()

    def orphans(self, query_id: int) -> Tuple[int, ...]:
        return tuple(sorted(self._orphans[query_id]))

    def state_mb(self, query_id: int) -> np.ndarray:
        """Per-op window-state footprint [MB] — the migration-cost unit."""
        q = self._queries[query_id]
        rt = analyze_operators(q, _dtype_mix(q))
        return np.array([rt[i].state_mb for i in range(q.n_ops())])

    def _own(self, q: Query) -> Query:
        return Query(
            operators=[op.replace() for op in q.operators],
            edges=list(q.edges),
            name=q.name,
        ).infer_widths()

    # -- contention --------------------------------------------------------------

    def _host_footprint(self, exclude: Optional[int] = None):
        """Fleet cpu load [ref-core-s/s] and state [MB] per host index."""
        n = self.cluster.n_nodes()
        load = np.zeros(n)
        state = np.zeros(n)
        for qid, q in self._queries.items():
            if qid == exclude:
                continue
            rt = analyze_operators(q, _dtype_mix(q))
            a = self._assign[qid]
            for op in q.operators:
                h = int(a[op.op_id])
                load[h] += rt[op.op_id].rate_in * rt[op.op_id].service_ms / 1e3
                state[h] += rt[op.op_id].state_mb
        return load, state

    def observed_cluster(self, query_id: Optional[int] = None) -> Cluster:
        """The cluster as host telemetry shows it to ``query_id``: each
        host's cpu/ram reduced by the other queries' resident load/state
        (and by any straggle slowdown).  This is both what the simulator
        runs the query against and what the controller may score against —
        contention enters through monitored residual capacity, not through
        simulator internals."""
        load, state = self._host_footprint(exclude=query_id)
        nodes = []
        for i, node in enumerate(self.cluster.nodes):
            slow = self._straggle.get(self._stable_ids[i], 1.0)
            cpu = max(node.cpu / slow - 100.0 * load[i], MIN_RESIDUAL_CPU)
            ram = max(node.ram_mb - state[i], MIN_RESIDUAL_RAM_MB)
            nodes.append(dc_replace(node, node_id=i, cpu=cpu, ram_mb=ram))
        return Cluster(nodes=nodes)

    # -- scenario events -----------------------------------------------------------

    def _apply_event(self, ev: ScenarioEvent) -> Optional[int]:
        if ev.kind in ("rate_drift", "selectivity_drift"):
            q = self._queries[ev.query]
            ops = []
            for op in q.operators:
                if ev.kind == "rate_drift" and op.op_type == OpType.SOURCE:
                    ops.append(op.replace(event_rate=op.event_rate * ev.factor))
                elif ev.kind == "selectivity_drift" and op.op_type in (
                    OpType.FILTER, OpType.JOIN, OpType.AGGREGATE,
                ):
                    sel = float(np.clip(op.selectivity * ev.factor, 0.01, 1.0))
                    ops.append(op.replace(selectivity=sel))
                else:
                    ops.append(op.replace())
            self._queries[ev.query] = Query(
                operators=ops, edges=list(q.edges), name=q.name
            ).infer_widths()
        elif ev.kind == "fail":
            if ev.host not in self._dead and ev.host in self._stable_ids:
                self._dead.add(ev.host)
                self.monitor.inject_failure(ev.host)
        elif ev.kind == "straggle":
            self._straggle[ev.host] = ev.factor
            if ev.host in self.monitor.hosts:
                self.monitor.inject_straggler(ev.host, ev.factor)
        elif ev.kind == "join":
            assert ev.node is not None, "join event needs a node spec"
            sid = self._next_stable
            self._next_stable += 1
            node = dc_replace(ev.node, node_id=self.cluster.n_nodes())
            self.cluster = Cluster(nodes=list(self.cluster.nodes) + [node])
            self._stable_ids.append(sid)
            self.monitor.hosts[sid] = VirtualHost(host_id=sid)
            self.monitor.heartbeat(sid, self.time_s)
            return sid
        return None

    def _evict(self, stable_id: int) -> None:
        """Remove a host: renumber survivors, remap every placement, park
        stranded operators as orphans on the lowest-numbered survivor."""
        idx = self._stable_ids.index(stable_id)
        survivors = [n for i, n in enumerate(self.cluster.nodes) if i != idx]
        assert survivors, "scenario evicted the last host"
        self.cluster = Cluster(
            nodes=[dc_replace(n, node_id=i) for i, n in enumerate(survivors)]
        )
        del self._stable_ids[idx]
        for qid, a in self._assign.items():
            stranded = np.where(a == idx)[0]
            a[a > idx] -= 1
            if len(stranded):
                # deterministic failover: the dead host's state is lost, its
                # operators restart on the parking host until the controller
                # re-places them
                a[stranded] = 0
                self._orphans[qid].update(int(s) for s in stranded)

    # -- migrations ----------------------------------------------------------------

    def apply(self, query_id: int, assignment: Sequence[int], downtime_s: float = 0.0) -> None:
        """Install a re-placement; ``downtime_s`` is charged to next tick."""
        a = np.asarray(assignment, dtype=np.int64)
        Placement.of(a).validate(self._queries[query_id], self.cluster)
        moved = np.where(a != self._assign[query_id])[0]
        self._assign[query_id] = a.copy()
        self._downtime[query_id] += float(downtime_s)
        self._orphans[query_id] -= {int(m) for m in moved}

    def adopt(self, query_id: int) -> None:
        """Accept the current (failover) placement as the query's new home:
        clears orphan status without a migration."""
        self._orphans[query_id].clear()

    # -- the tick ------------------------------------------------------------------

    def tick(self) -> FleetSnapshot:
        self.tick_idx += 1
        self.time_s += self.tick_s
        joined: List[int] = []
        for ev in self.events:
            if ev.tick == self.tick_idx:
                sid = self._apply_event(ev)
                if sid is not None:
                    joined.append(sid)

        # heartbeats + step reports from live hosts; dead hosts stay silent
        for sid in self._stable_ids:
            if sid in self._dead or sid not in self.monitor.hosts:
                continue
            self.monitor.heartbeat(sid, self.time_s)
            self.monitor.report_step(sid, BASE_STEP_S * self._straggle.get(sid, 1.0))

        evicted: List[Tuple[int, str]] = []
        flagged: List[Tuple[int, str]] = []
        for sid, reason in self.monitor.detect(self.time_s):
            if reason.startswith("heartbeat"):
                if sid in self._stable_ids:
                    self.monitor.evict(sid, reason, self.time_s)
                    self._evict(sid)
                    evicted.append((sid, reason))
            else:
                flagged.append((sid, reason))

        # per-query observed labels on the residual-capacity cluster
        obs: Dict[int, QueryObs] = {}
        for qid in self.query_ids:
            q = self._queries[qid]
            a = self._assign[qid]
            rng = np.random.default_rng((self.seed, self.tick_idx, qid, 0x7E1E))
            labels = simulate(
                q, self.observed_cluster(qid), Placement.of(a), self.sim_config, rng
            )
            down = self._downtime[qid]
            self._downtime[qid] = 0.0
            if down > 0.0:
                # migration downtime: the query is stopped for `down` seconds
                # of this tick — tuples queue at the broker and throughput
                # over the tick shrinks proportionally
                frac = min(down / self.tick_s, 1.0)
                labels = dc_replace(
                    labels,
                    throughput=labels.throughput * (1.0 - frac),
                    latency_e=labels.latency_e + down * 1e3,
                )
            cost = labels.latency_e if labels.success else FAIL_COST_MS
            obs[qid] = QueryObs(
                query_id=qid,
                labels=labels,
                cost_ms=float(cost),
                assignment=tuple(int(x) for x in a),
                orphaned=self.orphans(qid),
                downtime_s=down,
            )

        load, state = self._host_footprint()
        hosts = tuple(
            HostObs(
                index=i,
                stable_id=self._stable_ids[i],
                util=float(
                    load[i]
                    / max(self.cluster.node(i).cores()
                          / self._straggle.get(self._stable_ids[i], 1.0), 1e-9)
                ),
                state_mb=float(state[i]),
                straggle=self._straggle.get(self._stable_ids[i], 1.0),
            )
            for i in range(self.cluster.n_nodes())
        )
        return FleetSnapshot(
            tick=self.tick_idx,
            time_s=self.time_s,
            queries=obs,
            hosts=hosts,
            evicted=tuple(evicted),
            flagged=tuple(flagged),
            joined=tuple(joined),
        )


class SimulatorScorer:
    """Noise-free simulator oracle with the re-planner's scorer shape
    ``(query, cluster, assignments) -> {metric: (N,)}``.

    Stands in for a trained ``CostEstimator`` in tests, the demo, and the
    benchmark's decision-quality lanes, so controller behaviour is judged on
    placement decisions, not on a particular checkpoint's accuracy."""

    def __init__(self, config: Optional[SimulatorConfig] = None):
        self.config = (
            config if config is not None else SimulatorConfig(noise_sigma=0.0)
        )

    def __call__(self, query: Query, cluster: Cluster, assignments) -> Dict[str, np.ndarray]:
        rows = np.asarray(assignments, dtype=np.int64)
        out: Dict[str, List[float]] = {}
        rng = np.random.default_rng(0)  # unused at noise_sigma = 0
        for row in rows:
            labels = simulate(query, cluster, Placement.of(row), self.config, rng)
            for k, v in labels.as_dict().items():
                out.setdefault(k, []).append(v)
        return {k: np.asarray(v) for k, v in out.items()}


def plan_initial_fleet(
    queries: Sequence[Query],
    cluster: Cluster,
    k: int = 64,
    seed: int = 0,
    scorer=None,
    target_metric: str = "latency_e",
) -> List[Tuple[Query, Tuple[int, ...]]]:
    """Contention-aware greedy initial placement for a whole fleet.

    Queries are placed one at a time against the residual capacity left by
    the already-placed ones (the same footprint model ``FleetRuntime`` uses),
    each picking the best of ``k`` sampled candidates under ``scorer``
    (default: the noise-free simulator oracle) with failing/backpressured
    candidates heavily penalized.  This is "COSTREAM picks a good initial
    placement" — the starting state the drift scenario then invalidates.
    """
    from repro_torch.placement.enumerate import heuristic_placement, sample_assignment_matrix

    scorer = scorer if scorer is not None else SimulatorScorer()
    n = cluster.n_nodes()
    load = np.zeros(n)
    state = np.zeros(n)
    out: List[Tuple[Query, Tuple[int, ...]]] = []
    rng = np.random.default_rng((seed, 0xF1EE7))
    for q in queries:
        nodes = [
            dc_replace(
                node,
                cpu=max(node.cpu - 100.0 * load[i], MIN_RESIDUAL_CPU),
                ram_mb=max(node.ram_mb - state[i], MIN_RESIDUAL_RAM_MB),
            )
            for i, node in enumerate(cluster.nodes)
        ]
        residual = Cluster(nodes=nodes)
        cand = sample_assignment_matrix(q, residual, k, rng)
        if len(cand) == 0:
            cand = np.asarray([heuristic_placement(q, residual).assignment])
        scores = scorer(q, residual, cand)
        cost = np.asarray(scores[target_metric], dtype=np.float64).copy()
        if "success" in scores:
            cost += 1e9 * (np.asarray(scores["success"]) < 0.5)
        if "backpressure" in scores:
            cost += 1e6 * (np.asarray(scores["backpressure"]) < 0.5)
        a = cand[int(np.argmin(cost))]
        rt = analyze_operators(q, _dtype_mix(q))
        for op in q.operators:
            h = int(a[op.op_id])
            load[h] += rt[op.op_id].rate_in * rt[op.op_id].service_ms / 1e3
            state[h] += rt[op.op_id].state_mb
        out.append((q, tuple(int(x) for x in a)))
    return out


def seeded_events(
    n_ticks: int,
    n_queries: int,
    host_ids: Sequence[int],
    seed: int = 0,
    drift_factor: float = 4.0,
    n_drifts: int = 2,
    fail: bool = True,
    join_node: Optional[HardwareNode] = None,
) -> List[ScenarioEvent]:
    """A seeded drift+failure scenario: ``n_drifts`` rate drifts in the first
    half of the run, one host failure at midpoint, optional capacity join at
    the three-quarter mark.  Deterministic in ``seed``."""
    rng = np.random.default_rng((seed, 0xC0577EA))
    events: List[ScenarioEvent] = []
    drift_qs = rng.choice(n_queries, size=min(n_drifts, n_queries), replace=False)
    for i, qid in enumerate(sorted(int(x) for x in drift_qs)):
        tick = 2 + int(rng.integers(0, max(n_ticks // 3, 1)))
        events.append(
            ScenarioEvent(tick=tick, kind="rate_drift", query=qid, factor=drift_factor)
        )
    if fail and len(host_ids) > 1:
        victim = int(host_ids[int(rng.integers(1, len(host_ids)))])
        events.append(ScenarioEvent(tick=max(n_ticks // 2, 2), kind="fail", host=victim))
    if join_node is not None:
        events.append(
            ScenarioEvent(tick=max(3 * n_ticks // 4, 3), kind="join", node=join_node)
        )
    return sorted(events, key=lambda e: e.tick)
