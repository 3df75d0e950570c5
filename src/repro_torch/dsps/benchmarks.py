"""Unseen real-world benchmark queries (paper SVII-F / Table VI (B)).

Re-creations of the DSPBench-derived workloads the paper evaluates on:
advertisement (click/impression join), spike detection (sensor filter over a
windowed mean), and the DEBS'14 smart-grid global/local energy queries. Data
distributions differ from the synthetic corpus: widths, dtype mixes, and
selectivities are fixed by the scenario, and the smart-grid queries use a
window length unseen in training (the paper notes COSTREAM extrapolates to it).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.dsps.query import (
    AggFn,
    DType,
    FilterFn,
    Operator,
    OpType,
    Query,
    WindowSpec,
)


def advertisement(rate_clicks: float, rate_impressions: float) -> Query:
    """Clicks JOIN impressions within a window, then filtered (sub-query of [36])."""
    ops = [
        Operator(op_id=0, op_type=OpType.SOURCE, event_rate=rate_clicks, n_int=2, n_string=2),
        Operator(op_id=1, op_type=OpType.SOURCE, event_rate=rate_impressions, n_int=3, n_string=3),
        Operator(
            op_id=2,
            op_type=OpType.FILTER,
            filter_fn=FilterFn.NE,
            literal_dtype=DType.STRING,
            selectivity=0.82,
        ),
        Operator(
            op_id=3,
            op_type=OpType.JOIN,
            join_key_dtype=DType.STRING,
            window=WindowSpec(wtype="sliding", policy="time", size=4.0, slide_ratio=0.5),
            selectivity=0.004,
        ),
        Operator(op_id=4, op_type=OpType.SINK),
    ]
    edges = [(0, 3), (1, 2), (2, 3), (3, 4)]
    return Query(operators=ops, edges=edges, name="advertisement").infer_widths()


def spike_detection(rate: float) -> Query:
    """Moving average over sensor values, spikes filtered out (IoT use case)."""
    ops = [
        Operator(op_id=0, op_type=OpType.SOURCE, event_rate=rate, n_int=1, n_double=3),
        Operator(
            op_id=1,
            op_type=OpType.AGGREGATE,
            agg_fn=AggFn.MEAN,
            group_by_dtype=DType.INT,  # per-sensor moving average
            agg_dtype=DType.DOUBLE,
            window=WindowSpec(wtype="sliding", policy="count", size=90.0, slide_ratio=0.34),
            selectivity=0.06,
        ),
        Operator(
            op_id=2,
            op_type=OpType.FILTER,
            filter_fn=FilterFn.GT,
            literal_dtype=DType.DOUBLE,
            selectivity=0.03,  # spikes are rare
        ),
        Operator(op_id=3, op_type=OpType.SINK),
    ]
    edges = [(0, 1), (1, 2), (2, 3)]
    return Query(operators=ops, edges=edges, name="spike_detection").infer_widths()


def smart_grid_global(rate: float) -> Query:
    """DEBS'14: sliding-window global energy consumption (unseen window size)."""
    ops = [
        Operator(op_id=0, op_type=OpType.SOURCE, event_rate=rate, n_int=4, n_double=2),
        Operator(
            op_id=1,
            op_type=OpType.AGGREGATE,
            agg_fn=AggFn.SUM,
            group_by_dtype=DType.NONE,
            agg_dtype=DType.DOUBLE,
            # 30s sliding window: outside the Table-II time range [0.25..16]
            window=WindowSpec(wtype="sliding", policy="time", size=30.0, slide_ratio=0.4),
            selectivity=1.0,
        ),
        Operator(op_id=2, op_type=OpType.SINK),
    ]
    edges = [(0, 1), (1, 2)]
    return Query(operators=ops, edges=edges, name="smart_grid_global").infer_widths()


def smart_grid_local(rate: float) -> Query:
    """DEBS'14: per-household energy consumption (group-by over unseen window)."""
    ops = [
        Operator(op_id=0, op_type=OpType.SOURCE, event_rate=rate, n_int=4, n_double=2),
        Operator(
            op_id=1,
            op_type=OpType.AGGREGATE,
            agg_fn=AggFn.SUM,
            group_by_dtype=DType.INT,  # household id
            agg_dtype=DType.DOUBLE,
            window=WindowSpec(wtype="sliding", policy="time", size=30.0, slide_ratio=0.4),
            selectivity=0.12,
        ),
        Operator(
            op_id=2,
            op_type=OpType.AGGREGATE,
            agg_fn=AggFn.MEAN,
            group_by_dtype=DType.INT,
            agg_dtype=DType.DOUBLE,
            window=WindowSpec(wtype="tumbling", policy="time", size=8.0, slide_ratio=1.0),
            selectivity=0.2,
        ),
        Operator(op_id=3, op_type=OpType.SINK),
    ]
    edges = [(0, 1), (1, 2), (2, 3)]
    return Query(operators=ops, edges=edges, name="smart_grid_local").infer_widths()


BENCHMARKS = {
    "advertisement": lambda rng: advertisement(
        rate_clicks=float(rng.choice([100, 200, 400, 800, 1600])),
        rate_impressions=float(rng.choice([200, 400, 800, 1600, 3200])),
    ),
    "spike_detection": lambda rng: spike_detection(
        rate=float(rng.choice([400, 800, 1600, 3200, 6400, 12800]))
    ),
    "smart_grid_global": lambda rng: smart_grid_global(
        rate=float(rng.choice([400, 800, 1600, 3200, 6400]))
    ),
    "smart_grid_local": lambda rng: smart_grid_local(
        rate=float(rng.choice([400, 800, 1600, 3200, 6400]))
    ),
}


def sample_benchmark_query(name: str, rng: np.random.Generator) -> Query:
    return BENCHMARKS[name](rng)
