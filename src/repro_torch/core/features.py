"""Transferable featurization (paper SIV-B, Tables I & II).

Maps operators and hardware nodes to fixed-width numeric vectors. Only
*transferable* quantities appear (no hostnames, no literals): log-scaled
magnitudes normalized against generous bounds around the Table-II ranges so
that inter-/extrapolated values stay finite and ordered, plus one-hots for
categorical operator properties.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dsps import ranges
from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.dsps.query import AggFn, DType, FilterFn, Operator, OpType, Query

# Node-type ids for operator nodes (banked encoders index on these).
OP_TYPE_IDS = {
    OpType.SOURCE: 0,
    OpType.FILTER: 1,
    OpType.AGGREGATE: 2,
    OpType.JOIN: 3,
    OpType.SINK: 4,
}
N_OP_TYPES = 5

_FILTER_FNS = [f.value for f in FilterFn]
_AGG_FNS = [f.value for f in AggFn]
_DTYPES3 = [DType.INT, DType.DOUBLE, DType.STRING]
_DTYPES4 = [DType.INT, DType.DOUBLE, DType.STRING, DType.NONE]

# ---------------------------------------------------------------------------
# Feature layout (operator nodes). Keep in sync with OP_FEATURE_DIM.
# ---------------------------------------------------------------------------
# 0  tuple_width_in   (log-norm)
# 1  tuple_width_out  (log-norm)
# 2  event_rate       (log-norm; sources only)
# 3  n_int / width    ; 4 n_double / width ; 5 n_string / width
# 6..12  filter_fn one-hot (7)
# 13..15 literal_dtype one-hot (3)
# 16 selectivity (log-norm)
# 17..19 join_key_dtype one-hot (3)
# 20..23 agg_fn one-hot (4)
# 24..27 group_by_dtype one-hot (4)
# 28..30 agg_dtype one-hot (3)
# 31..32 window type one-hot (sliding, tumbling)
# 33..34 window policy one-hot (count, time)
# 35 window size count (log-norm; 0 when time-based)
# 36 window size time  (log-norm; 0 when count-based)
# 37 slide ratio
# 38 is_stateful flag
OP_FEATURE_DIM = 39
HW_FEATURE_DIM = 4  # cpu, ram, bandwidth, latency (all log-norm)


def lognorm(x: float, key: str) -> float:
    lo, hi = ranges.LOG_BOUNDS[key]
    x = max(float(x), 1e-12)
    return (math.log(x) - math.log(lo)) / (math.log(hi) - math.log(lo))


def featurize_operator(op: Operator) -> np.ndarray:
    v = np.zeros((OP_FEATURE_DIM,), dtype=np.float32)
    v[0] = lognorm(max(op.tuple_width_in, 1.0), "tuple_width")
    v[1] = lognorm(max(op.tuple_width_out, 1.0), "tuple_width")
    if op.op_type == OpType.SOURCE:
        v[2] = lognorm(op.event_rate, "event_rate")
        width = max(op.n_int + op.n_double + op.n_string, 1)
        v[3] = op.n_int / width
        v[4] = op.n_double / width
        v[5] = op.n_string / width
    if op.op_type == OpType.FILTER:
        v[6 + _FILTER_FNS.index(op.filter_fn.value)] = 1.0
        v[13 + _DTYPES3.index(op.literal_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.op_type == OpType.JOIN:
        v[17 + _DTYPES3.index(op.join_key_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.op_type == OpType.AGGREGATE:
        v[20 + _AGG_FNS.index(op.agg_fn.value)] = 1.0
        v[24 + _DTYPES4.index(op.group_by_dtype)] = 1.0
        v[28 + _DTYPES3.index(op.agg_dtype)] = 1.0
        v[16] = lognorm(op.selectivity, "selectivity")
    if op.window is not None:
        v[31 + (0 if op.window.wtype == "sliding" else 1)] = 1.0
        v[33 + (0 if op.window.policy == "count" else 1)] = 1.0
        if op.window.policy == "count":
            v[35] = lognorm(op.window.size, "window_count")
        else:
            v[36] = lognorm(op.window.size, "window_time_s")
        v[37] = op.window.slide_ratio
    v[38] = 1.0 if op.is_stateful() else 0.0
    return v


def featurize_hardware(node: HardwareNode) -> np.ndarray:
    return np.array(
        [
            lognorm(node.cpu, "cpu"),
            lognorm(node.ram_mb, "ram_mb"),
            lognorm(node.bandwidth_mbps, "bandwidth_mbps"),
            lognorm(node.latency_ms, "latency_ms"),
        ],
        dtype=np.float32,
    )


def op_type_id(op: Operator) -> int:
    return OP_TYPE_IDS[op.op_type]
