"""Analytic DSPS cost simulator: the label oracle of the benchmark corpus.

Given (query, cluster, placement) this computes the paper's five cost metrics

    C = (T, L_p, L_e, R_O, S)

via a queueing-network model of a JVM streaming engine:

* per-tuple service demands per operator derived from operator type, tuple
  width, attribute data types, and window state (paper Table I features);
* host capacity from the relative ``cpu`` feature; co-located operators share
  the host (paper Fig. 5 (1));
* windowed state sized from window length x tuple width x dtype byte widths;
  RAM exhaustion models GC pressure -> slowdown -> crash (paper Def. 5 (1));
* per-link flows from tuple rate x tuple byte width; saturation of a host's
  outgoing bandwidth causes backpressure just like CPU saturation;
* M/M/1-style waiting times + window residence + per-hop network latency
  accumulate into L_p along the critical source->sink path; L_e adds broker
  queueing which explodes under backpressure (paper Def. 3/4);
* logical failure when no tuple reaches the sink within the measurement
  interval (paper Def. 5 (2));
* log-normal measurement noise on the regression metrics.

All computations are plain Python/numpy (the corpus generator is host-side);
the learned model in ``repro_torch.core`` never sees any of these internals — only
the transferable features and the resulting labels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import DType, Operator, OpType, Query

# ---------------------------------------------------------------------------
# Cost constants (reference-core milliseconds / bytes). These play the role of
# the physical machine behaviour the paper measures; they are fixed across the
# whole corpus so the learning problem is about *structure*, not constants.
# ---------------------------------------------------------------------------
BYTES_PER_ATTR = {DType.INT: 8.0, DType.DOUBLE: 8.0, DType.STRING: 64.0, DType.NONE: 0.0}
CPU_COST_DTYPE = {DType.INT: 1.0, DType.DOUBLE: 1.15, DType.STRING: 2.6, DType.NONE: 0.0}

MS_SOURCE_BASE = 0.012  # deserialization + emit
MS_SOURCE_PER_ATTR = 0.0015
MS_FILTER_BASE = 0.004
MS_FILTER_CMP = 0.0025  # x dtype factor
MS_AGG_UPDATE = 0.006  # per-tuple state update, x dtype factor
MS_AGG_GROUP_HASH = 0.004  # extra per-tuple if group-by, x dtype factor
MS_AGG_EMIT = 0.008  # per emitted row
MS_JOIN_INSERT = 0.007  # per-tuple window insert, x key dtype factor
MS_JOIN_PROBE = 0.004  # per-tuple hash probe, x key dtype factor
MS_JOIN_EMIT = 0.0045  # per emitted match (pair materialization)
MS_SINK_BASE = 0.010
MS_SINK_PER_ATTR = 0.0012
MS_NET_PER_TUPLE = 0.002  # serialization overhead for remote sends

JVM_BASE_MB = 384.0  # engine worker footprint per host
STATE_OVERHEAD = 1.6  # JVM object header / boxing overhead on window state
GC_SOFT = 0.60  # state/heap ratio where GC pressure starts to bite
GC_HARD = 1.00  # state/heap ratio beyond which the worker crashes
MEASUREMENT_S = 240.0  # paper: 4-minute measured executions

EPS = 1e-9


@dataclass(frozen=True)
class CostLabels:
    """The five cost metrics of the paper (SIV-A)."""

    throughput: float  # T      [tuples/s at the sink]
    latency_p: float  # L_p    [ms]
    latency_e: float  # L_e    [ms]
    backpressure: int  # R_O    1 = no backpressure, 0 = backpressured (paper Def. 4)
    success: int  # S      1 = tuples reached the sink, 0 = failed

    def as_dict(self) -> Dict[str, float]:
        return {
            "throughput": self.throughput,
            "latency_p": self.latency_p,
            "latency_e": self.latency_e,
            "backpressure": float(self.backpressure),
            "success": float(self.success),
        }


@dataclass(frozen=True)
class SimulatorConfig:
    noise_sigma: float = 0.12  # log-normal noise on regression metrics
    broker_base_ms: float = 8.0  # Kafka hand-off under no backpressure
    crash_under_hard_gc: bool = True
    seed_salt: int = 0x5EED


# ---------------------------------------------------------------------------
# Per-operator analytic quantities
# ---------------------------------------------------------------------------


def tuple_bytes(width: float, mix: Tuple[float, float, float]) -> float:
    """Average serialized bytes of a tuple of ``width`` attributes.

    ``mix`` = fraction of (int, double, string) attributes.
    """
    fi, fd, fs = mix
    per = fi * BYTES_PER_ATTR[DType.INT] + fd * BYTES_PER_ATTR[DType.DOUBLE] + fs * BYTES_PER_ATTR[
        DType.STRING
    ]
    return 24.0 + width * per  # 24B envelope (timestamps, ids)


def _dtype_factor(dt: Optional[DType]) -> float:
    return CPU_COST_DTYPE.get(dt if dt is not None else DType.INT, 1.0)


@dataclass
class OpRuntime:
    """Derived steady-state quantities for one operator."""

    rate_in: float = 0.0  # tuples/s arriving (sum over inputs)
    rate_out: float = 0.0  # tuples/s emitted
    service_ms: float = 0.0  # reference-core ms per input tuple (incl. emission)
    state_mb: float = 0.0  # window state resident bytes
    window_wait_ms: float = 0.0  # residence time until a tuple can be emitted
    bytes_out_per_s: float = 0.0


def analyze_operators(query: Query, dtype_mix: Tuple[float, float, float]) -> Dict[int, OpRuntime]:
    """Propagate rates/widths/state through the logical data flow."""
    rt: Dict[int, OpRuntime] = {i: OpRuntime() for i in range(query.n_ops())}
    order = query.topological_order()
    for u in order:
        op = query.op(u)
        r = rt[u]
        parents = query.parents(u)
        in_rates = [rt[p].rate_out for p in parents]
        r.rate_in = float(sum(in_rates))
        if op.op_type == OpType.SOURCE:
            r.rate_in = op.event_rate
            r.rate_out = op.event_rate
            r.service_ms = MS_SOURCE_BASE + MS_SOURCE_PER_ATTR * op.tuple_width_in
        elif op.op_type == OpType.FILTER:
            r.rate_out = r.rate_in * op.selectivity
            r.service_ms = MS_FILTER_BASE + MS_FILTER_CMP * _dtype_factor(op.literal_dtype)
        elif op.op_type == OpType.AGGREGATE:
            w = op.window
            assert w is not None
            win_len = w.length_tuples(r.rate_in)
            period = w.period_seconds(r.rate_in)
            groups = max(1.0, op.selectivity * win_len)
            emits_per_s = groups / max(period, EPS)
            r.rate_out = emits_per_s
            grouped = op.group_by_dtype not in (None, DType.NONE)
            per_tuple = MS_AGG_UPDATE * _dtype_factor(op.agg_dtype)
            if grouped:
                per_tuple += MS_AGG_GROUP_HASH * _dtype_factor(op.group_by_dtype)
            emit_ms = MS_AGG_EMIT * (emits_per_s / max(r.rate_in, EPS))
            r.service_ms = per_tuple + emit_ms
            r.state_mb = (
                win_len
                * tuple_bytes(op.tuple_width_in, dtype_mix)
                * STATE_OVERHEAD
                * (2.0 if w.wtype == "sliding" else 1.0)
            ) / 1e6
            # expected residence of a tuple before its window fires
            r.window_wait_ms = 0.5 * period * 1e3 if w.wtype == "tumbling" else 0.5 * w.slide() * (
                1e3 if w.policy == "time" else 1e3 / max(r.rate_in, EPS)
            )
        elif op.op_type == OpType.JOIN:
            w = op.window
            assert w is not None
            assert len(parents) == 2, "join expects two inputs"
            r1, r2 = in_rates
            w1 = w.length_tuples(max(r1, EPS))
            w2 = w.length_tuples(max(r2, EPS))
            # each arrival probes the opposite window; matches = sel x |W_opp|
            matches_per_s = op.selectivity * (r1 * w2 + r2 * w1)
            r.rate_out = matches_per_s
            kf = _dtype_factor(op.join_key_dtype)
            emit_ms = MS_JOIN_EMIT * (matches_per_s / max(r.rate_in, EPS))
            r.service_ms = (MS_JOIN_INSERT + MS_JOIN_PROBE) * kf + emit_ms
            width_avg = op.tuple_width_in / 2.0
            r.state_mb = (
                (w1 + w2)
                * tuple_bytes(width_avg, dtype_mix)
                * STATE_OVERHEAD
                * (2.0 if w.wtype == "sliding" else 1.0)
            ) / 1e6
            mean_rate = 0.5 * (max(r1, EPS) + max(r2, EPS))
            r.window_wait_ms = 0.5 * w.period_seconds(mean_rate) * 1e3
        elif op.op_type == OpType.SINK:
            r.rate_out = r.rate_in
            r.service_ms = MS_SINK_BASE + MS_SINK_PER_ATTR * op.tuple_width_in
        rt[u] = r
    return rt


# ---------------------------------------------------------------------------
# The simulator proper
# ---------------------------------------------------------------------------


def _dtype_mix(query: Query) -> Tuple[float, float, float]:
    ni = nd = ns = 0
    for op in query.operators:
        if op.op_type == OpType.SOURCE:
            ni += op.n_int
            nd += op.n_double
            ns += op.n_string
    tot = max(ni + nd + ns, 1)
    return (ni / tot, nd / tot, ns / tot)


def simulate(
    query: Query,
    cluster: Cluster,
    placement: Placement,
    config: SimulatorConfig = SimulatorConfig(),
    rng: Optional[np.random.Generator] = None,
) -> CostLabels:
    """Compute C = (T, L_p, L_e, R_O, S) for a placed query."""
    placement.validate(query, cluster)
    mix = _dtype_mix(query)
    rt = analyze_operators(query, mix)

    # --- host CPU utilization (co-location shares the host) -----------------
    host_load: Dict[int, float] = {}  # ref-core-seconds of work per second
    host_state: Dict[int, float] = {}
    for op in query.operators:
        n = placement.node_of(op.op_id)
        work = rt[op.op_id].rate_in * rt[op.op_id].service_ms / 1e3
        host_load[n] = host_load.get(n, 0.0) + work
        host_state[n] = host_state.get(n, 0.0) + rt[op.op_id].state_mb

    # GC pressure per host: state vs. heap (RAM minus worker footprint).
    gc_slow: Dict[int, float] = {}
    crashed = False
    for n, state_mb in host_state.items():
        heap = max(cluster.node(n).ram_mb - JVM_BASE_MB, 64.0)
        ratio = state_mb / heap
        if ratio >= GC_HARD and config.crash_under_hard_gc:
            crashed = True
        # GC slowdown factor >= 1, ramping up once past the soft threshold
        gc_slow[n] = 1.0 + max(0.0, (ratio - GC_SOFT) / max(1.0 - GC_SOFT, EPS)) ** 2 * 6.0

    host_util: Dict[int, float] = {}
    for n, load in host_load.items():
        cap = cluster.node(n).cores()
        host_util[n] = load * gc_slow.get(n, 1.0) / max(cap, EPS)

    # --- network flows (remote data-flow edges) ------------------------------
    # bytes/s leaving each host + per logical edge utilization of its link
    out_bytes: Dict[int, float] = {}
    edge_link_util: Dict[Tuple[int, int], float] = {}
    for u, v in query.edges:
        nu, nv = placement.node_of(u), placement.node_of(v)
        if nu == nv:
            continue
        width = query.op(u).tuple_width_out
        flow = rt[u].rate_out * tuple_bytes(width, mix)  # bytes/s
        out_bytes[nu] = out_bytes.get(nu, 0.0) + flow
        # remote sends also cost CPU on the sender
        host_load[nu] = host_load.get(nu, 0.0) + rt[u].rate_out * MS_NET_PER_TUPLE / 1e3
    for n, flow in out_bytes.items():
        cap_bytes = cluster.node(n).bandwidth_mbps * 1e6 / 8.0
        util = flow / max(cap_bytes, EPS)
        host_util[n] = max(host_util.get(n, 0.0), util)  # whichever saturates first
        edge_link_util[(n, -1)] = util

    # refresh utilization after adding network CPU cost
    for n, load in host_load.items():
        cap = cluster.node(n).cores()
        host_util[n] = max(
            host_util.get(n, 0.0), load * gc_slow.get(n, 1.0) / max(cap, EPS)
        )

    # --- backpressure & sustainable throughput -------------------------------
    rho_max = max(host_util.values()) if host_util else 0.0
    backpressured = rho_max >= 1.0
    throttle = min(1.0, 1.0 / max(rho_max, EPS)) if rho_max > 0 else 1.0

    sink_rate = rt[query.sink()].rate_in  # tuples/s arriving at the sink
    throughput = sink_rate * throttle

    # --- success -------------------------------------------------------------
    expected_out = throughput * MEASUREMENT_S
    success = 1
    if crashed:
        success = 0
    if expected_out < 1.0:
        success = 0
    if rho_max > 4.0:  # catastrophic overload: workers die before stabilizing
        success = 0

    # --- latencies along the critical path -----------------------------------
    # queueing wait at each op: M/M/1 with effective utilization of its host
    def op_wait_ms(op_id: int) -> float:
        n = placement.node_of(op_id)
        rho = min(host_util.get(n, 0.0), 0.995)
        svc = rt[op_id].service_ms * gc_slow.get(n, 1.0)
        return svc / max(1.0 - rho, 0.005) + rt[op_id].window_wait_ms

    def hop_ms(u: int, v: int) -> float:
        nu, nv = placement.node_of(u), placement.node_of(v)
        if nu == nv:
            return 0.05  # intra-host queue hand-off
        bw_mbps, lat_ms = cluster.link(nu, nv)
        width = query.op(u).tuple_width_out
        per_tuple_ms = tuple_bytes(width, mix) * 8.0 / max(bw_mbps * 1e6, EPS) * 1e3
        # link queueing inflation when close to saturation
        util = min(out_bytes.get(nu, 0.0) / max(bw_mbps * 1e6 / 8.0, EPS), 0.995)
        return lat_ms + per_tuple_ms / max(1.0 - util, 0.005)

    sink = query.sink()
    memo: Dict[int, float] = {}

    def path_ms(u: int) -> float:
        if u in memo:
            return memo[u]
        best = 0.0
        for v in query.children(u):
            best = max(best, hop_ms(u, v) + path_ms(v))
        memo[u] = op_wait_ms(u) + best
        return memo[u]

    latency_p = max(path_ms(s) for s in query.sources())

    # --- end-to-end latency: broker wait --------------------------------------
    if backpressured:
        # queues build for the whole measured interval; average waiting time of
        # an admitted tuple grows with the unprocessed fraction
        backlog_frac = max(0.0, 1.0 - throttle)
        broker_ms = config.broker_base_ms + 0.5 * MEASUREMENT_S * 1e3 * backlog_frac
    else:
        # near-saturation brokers already add queueing
        broker_ms = config.broker_base_ms / max(1.0 - min(rho_max, 0.99), 0.05)
    latency_e = latency_p + broker_ms

    # --- measurement noise -----------------------------------------------------
    if rng is None:
        rng = np.random.default_rng(
            abs(hash((query.name, placement.assignment, config.seed_salt))) % (2**32)
        )
    noise = lambda: float(np.exp(rng.normal(0.0, config.noise_sigma)))
    throughput = throughput * noise()
    latency_p = latency_p * noise()
    # broker wait gets its own noise; L_e >= L_p holds by construction
    latency_e = latency_p + broker_ms * noise()

    if success == 0:
        throughput = 0.0

    return CostLabels(
        throughput=float(max(throughput, 0.0)),
        latency_p=float(max(latency_p, 0.05)),
        latency_e=float(max(latency_e, 0.05)),
        backpressure=0 if backpressured else 1,
        success=int(success),
    )
