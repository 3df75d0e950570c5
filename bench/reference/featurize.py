"""The plain reference's featurizer: placed queries as the paper's joint operator-resource graph.

A frozen copy of the port's ``core/features.py`` and the canonical padded layout of
``core/graph.py`` (paper Sec. IV-B, Tables I and II), over the benchmark's own types
(``harness/workload.py``).  NumPy only; it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import numpy as np

MAX_OPS = 12
MAX_HW = 8
MAX_DEPTH = 8
OP_FEATURE_DIM = 39
HW_FEATURE_DIM = 4
TYPE_ID = {"source": 0, "filter": 1, "aggregate": 2, "join": 3, "sink": 4}
N_TYPES = 5
# (type id, first slot, stop): sources, filters, joins, aggregations, the sink
SLOT_RANGES = ((0, 0, 3), (1, 3, 7), (3, 7, 9), (2, 9, 11), (4, 11, 12))

LOG_BOUNDS = {
    "cpu": (10.0, 3200.0),
    "ram_mb": (250.0, 128000.0),
    "bandwidth_mbps": (5.0, 40000.0),
    "latency_ms": (0.25, 640.0),
    "event_rate": (5.0, 102400.0),
    "tuple_width": (1.0, 40.0),
    "selectivity": (1e-4, 1.0),
    "window_count": (1.0, 2560.0),
    "window_time_s": (0.05, 64.0),
}
FILTER_FNS = ("<", ">", "<=", ">=", "!=", "startswith", "endswith")
AGG_FNS = ("min", "max", "mean", "sum")
DTYPES3 = ("int", "double", "string")
DTYPES4 = ("int", "double", "string", "none")


class Graphs(NamedTuple):
    """A batch of padded joint graphs, as NumPy arrays with a leading batch axis."""

    op_x: np.ndarray  # (B, 12, 39) float32
    op_type: np.ndarray  # (B, 12) int64; padded slots carry their range's type
    op_mask: np.ndarray  # (B, 12) float32
    op_depth: np.ndarray  # (B, 12) int64
    hw_x: np.ndarray  # (B, 8, 4) float32
    hw_mask: np.ndarray  # (B, 8) float32
    a_flow: np.ndarray  # (B, 12, 12) float32, [u, v] = 1 iff u -> v
    a_place: np.ndarray  # (B, 12, 8) float32, [i, j] = 1 iff operator i runs on host j


def lognorm(x: float, key: str) -> float:
    lo, hi = LOG_BOUNDS[key]
    return (math.log(max(float(x), 1e-12)) - math.log(lo)) / (math.log(hi) - math.log(lo))


def operator_features(op) -> np.ndarray:
    v = np.zeros((OP_FEATURE_DIM,), dtype=np.float32)
    v[0] = lognorm(max(op.width_in, 1.0), "tuple_width")
    v[1] = lognorm(max(op.width_out, 1.0), "tuple_width")
    if op.kind == "source":
        v[2] = lognorm(op.event_rate, "event_rate")
        width = max(op.n_int + op.n_double + op.n_string, 1)
        v[3], v[4], v[5] = op.n_int / width, op.n_double / width, op.n_string / width
    if op.kind == "filter":
        v[6 + FILTER_FNS.index(op.filter_fn)] = 1.0
        v[13 + DTYPES3.index(op.literal_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.kind == "join":
        v[17 + DTYPES3.index(op.join_key_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.kind == "aggregate":
        v[20 + AGG_FNS.index(op.agg_fn)] = 1.0
        v[24 + DTYPES4.index(op.group_by_dtype)] = 1.0
        v[28 + DTYPES3.index(op.agg_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.window is not None:
        v[31 + (0 if op.window.wtype == "sliding" else 1)] = 1.0
        v[33 + (0 if op.window.policy == "count" else 1)] = 1.0
        if op.window.policy == "count":
            v[35] = lognorm(op.window.size, "window_count")
        else:
            v[36] = lognorm(op.window.size, "window_time_s")
        v[37] = op.window.slide_ratio
    v[38] = 1.0 if op.kind in ("aggregate", "join") else 0.0
    return v


def host_features(h) -> np.ndarray:
    return np.array([lognorm(h.cpu, "cpu"), lognorm(h.ram_mb, "ram_mb"),
                     lognorm(h.bandwidth_mbps, "bandwidth_mbps"), lognorm(h.latency_ms, "latency_ms")],
                    dtype=np.float32)


def slots(query) -> np.ndarray:
    """Each operator's padded row: the next free slot of its type's range, in operator order."""
    start = {t: a for t, a, _ in SLOT_RANGES}
    stop = {t: b for t, _, b in SLOT_RANGES}
    used: Dict[int, int] = {}
    out = []
    for op in query.ops:
        t = TYPE_ID[op.kind]
        s = start[t] + used.get(t, 0)
        if s >= stop[t]:
            raise ValueError(f"query {query.name} has more {op.kind} operators than the layout holds")
        used[t] = used.get(t, 0) + 1
        out.append(s)
    return np.asarray(out, dtype=np.int64)


def skeleton(query, cluster) -> Graphs:
    """One (query, cluster) pair's graph with no placement, as a batch of one."""
    if len(query.ops) > MAX_OPS or len(cluster) > MAX_HW:
        raise ValueError(f"{len(query.ops)} operators or {len(cluster)} hosts exceed the layout")
    op_x = np.zeros((1, MAX_OPS, OP_FEATURE_DIM), np.float32)
    op_type = np.zeros((1, MAX_OPS), np.int64)
    for t, a, b in SLOT_RANGES:
        op_type[0, a:b] = t
    op_mask = np.zeros((1, MAX_OPS), np.float32)
    op_depth = np.zeros((1, MAX_OPS), np.int64)
    hw_x = np.zeros((1, MAX_HW, HW_FEATURE_DIM), np.float32)
    hw_mask = np.zeros((1, MAX_HW), np.float32)
    a_flow = np.zeros((1, MAX_OPS, MAX_OPS), np.float32)
    row = slots(query)
    for i, (op, d) in enumerate(zip(query.ops, query.depths())):
        op_x[0, row[i]] = operator_features(op)
        op_type[0, row[i]] = TYPE_ID[op.kind]
        op_mask[0, row[i]] = 1.0
        op_depth[0, row[i]] = d
    for j, h in enumerate(cluster):
        hw_x[0, j] = host_features(h)
        hw_mask[0, j] = 1.0
    for u, v in query.edges:
        a_flow[0, row[u], row[v]] = 1.0
    return Graphs(op_x, op_type, op_mask, op_depth, hw_x, hw_mask, a_flow,
                  np.zeros((1, MAX_OPS, MAX_HW), np.float32))


def placements(query, assignments: np.ndarray) -> np.ndarray:
    """``(N, 12, 8)`` placement adjacencies of an ``(N, n_ops)`` assignment matrix."""
    assignments = np.asarray(assignments, dtype=np.int64)
    n = assignments.shape[0]
    a = np.zeros((n, MAX_OPS, MAX_HW), np.float32)
    a[np.arange(n)[:, None], slots(query)[None, :], assignments] = 1.0
    return a


def placed(query, cluster, assignments: np.ndarray) -> Graphs:
    """The skeleton broadcast against ``N`` placements."""
    s = skeleton(query, cluster)
    n = len(assignments)
    return Graphs(*[np.repeat(x, n, axis=0) for x in s[:-1]], placements(query, assignments))


def traces(items: Sequence) -> Graphs:
    """A batch of placed queries (``workload.Trace``), one graph each."""
    parts = [placed(t.query, t.cluster, np.asarray([t.assignment])) for t in items]
    return concat(parts)


def concat(parts: Sequence[Graphs]) -> Graphs:
    return Graphs(*[np.concatenate([getattr(p, f) for p in parts]) for f in Graphs._fields])


def take(g: Graphs, idx) -> Graphs:
    return Graphs(*[x[idx] for x in g])
