"""Flat-vector baseline (paper SVII, after Ganapathi et al. [16]), in PyTorch.

The port of ``repro/core/flat_vector.py``: ``featurize_flat`` is a numpy copy
of the JAX package's and agrees with it exactly; the model is the same MLP on
``repro_torch.nn``.

The baseline encodes a placed query as ONE fixed-width vector: aggregate query
statistics (operator counts, mean selectivities, window sizes, event rates)
plus aggregate hardware statistics (mean/min/max of the cluster features).
Crucially — and this is the point the paper makes — the *structural* coupling
between individual operators and the hosts they are placed on cannot be
represented, so placement-sensitive cost effects are invisible to it.

The paper trains LightGBM on this vector; lightgbm is not available offline,
so the baseline regressor/classifier is an MLP trained with the identical
losses (MSLE / BCE) — if anything a stronger baseline than boosted trees on a
39-dim dense vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.features import lognorm
from repro_torch.dsps.generator import Trace
from repro_torch.dsps.hardware import Cluster
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import OpType, Query

FLAT_DIM = 39


def featurize_flat(query: Query, cluster: Cluster, placement: Placement) -> np.ndarray:
    v = np.zeros((FLAT_DIM,), dtype=np.float32)
    ops = query.operators
    srcs = [o for o in ops if o.op_type == OpType.SOURCE]
    filts = [o for o in ops if o.op_type == OpType.FILTER]
    joins = [o for o in ops if o.op_type == OpType.JOIN]
    aggs = [o for o in ops if o.op_type == OpType.AGGREGATE]

    # query-structure aggregates
    v[0] = len(ops) / 12.0
    v[1] = len(srcs) / 3.0
    v[2] = len(filts) / 4.0
    v[3] = len(joins) / 2.0
    v[4] = len(aggs) / 2.0
    # data aggregates
    rates = [o.event_rate for o in srcs]
    v[5] = lognorm(float(np.sum(rates)), "event_rate")
    v[6] = lognorm(float(np.max(rates)), "event_rate")
    widths = [o.tuple_width_in for o in srcs]
    v[7] = lognorm(float(np.mean(widths)), "tuple_width")
    mix = np.array(
        [sum(o.n_int for o in srcs), sum(o.n_double for o in srcs), sum(o.n_string for o in srcs)],
        dtype=np.float32,
    )
    v[8:11] = mix / max(mix.sum(), 1.0)
    # selectivity aggregates
    if filts:
        v[11] = lognorm(float(np.prod([o.selectivity for o in filts])), "selectivity")
        v[12] = lognorm(float(np.min([o.selectivity for o in filts])), "selectivity")
    if joins:
        v[13] = lognorm(float(np.mean([o.selectivity for o in joins])), "selectivity")
    if aggs:
        v[14] = lognorm(float(np.mean([o.selectivity for o in aggs])), "selectivity")
    # window aggregates over all stateful ops
    stateful = joins + aggs
    if stateful:
        counts = [o.window.size for o in stateful if o.window.policy == "count"]
        times = [o.window.size for o in stateful if o.window.policy == "time"]
        v[15] = lognorm(float(np.mean(counts)), "window_count") if counts else 0.0
        v[16] = lognorm(float(np.mean(times)), "window_time_s") if times else 0.0
        v[17] = float(np.mean([o.window.slide_ratio for o in stateful]))
        v[18] = float(np.mean([1.0 if o.window.wtype == "sliding" else 0.0 for o in stateful]))
        v[19] = float(np.mean([1.0 if o.window.policy == "count" else 0.0 for o in stateful]))
    # hardware aggregates over the *used* hosts (the placement's only trace)
    used = [cluster.node(n) for n in placement.used_nodes()]
    feats = np.array(
        [[h.cpu, h.ram_mb, h.bandwidth_mbps, h.latency_ms] for h in used], dtype=np.float64
    )
    keys = ["cpu", "ram_mb", "bandwidth_mbps", "latency_ms"]
    for j, k in enumerate(keys):
        v[20 + 3 * j + 0] = lognorm(float(feats[:, j].mean()), k)
        v[20 + 3 * j + 1] = lognorm(float(feats[:, j].min()), k)
        v[20 + 3 * j + 2] = lognorm(float(feats[:, j].max()), k)
    # co-location coarse stats (count-only; no structure)
    v[32] = len(used) / 8.0
    v[33] = len(ops) / max(len(used), 1) / 12.0
    n_remote = sum(
        1 for (a, b) in query.edges if placement.node_of(a) != placement.node_of(b)
    )
    v[34] = n_remote / 12.0
    v[35] = query.max_depth() / 12.0
    return v


def featurize_flat_traces(traces: List[Trace]) -> np.ndarray:
    return np.stack([featurize_flat(t.query, t.cluster, t.placement) for t in traces])


# -- the baseline model (MLP on the flat vector) ---------------------------------


@dataclass(frozen=True)
class FlatVectorConfig:
    hidden: int = 128
    n_layers: int = 3
    task: str = "regression"  # regression | classification


def init_flat_model(gen: torch.Generator, cfg: FlatVectorConfig) -> nn.Params:
    """The MLP's params on the CPU, drawn from ``gen`` (glorot normal, zero bias)."""
    sizes = [FLAT_DIM] + [cfg.hidden] * (cfg.n_layers - 1) + [1]
    return nn.init_mlp(gen, sizes)


def forward_flat(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """(..., FLAT_DIM) flat vectors -> (...) raw outputs (log1p cost or logit)."""
    return nn.apply_mlp(params, x)[..., 0]
