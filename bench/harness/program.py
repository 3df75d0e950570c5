"""The system under test: the port's ``CostEstimator``, driven through its bulk entries.

This is the one module of the harness that imports the program (``repro_torch``).  It hands the
program the benchmark's inputs in the program's own types (``to_query``, ``to_cluster``), builds
the estimator over the benchmark's weights, featurizes the estimation pools with the program's own
featurizer in set-up, and issues one call of a traffic mix as ``dispatch(i)`` (the call queued on
the device, ``deferred=True``) and ``finish(handle)`` (its answers in hand, flattened per metric in
the order of ``Traffic.item_ids``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench.harness import workload as W
from bench.harness.traffic import Traffic


def to_query(q: W.Query):
    from repro_torch.dsps.query import AggFn, DType, FilterFn, Operator, OpType, Query, WindowSpec

    ops = []
    for i, op in enumerate(q.ops):
        win = op.window
        ops.append(Operator(
            op_id=i, op_type=OpType(op.kind), tuple_width_in=op.width_in, tuple_width_out=op.width_out,
            event_rate=op.event_rate, n_int=op.n_int, n_double=op.n_double, n_string=op.n_string,
            filter_fn=None if op.filter_fn is None else FilterFn(op.filter_fn),
            literal_dtype=None if op.literal_dtype is None else DType(op.literal_dtype),
            join_key_dtype=None if op.join_key_dtype is None else DType(op.join_key_dtype),
            agg_fn=None if op.agg_fn is None else AggFn(op.agg_fn),
            group_by_dtype=None if op.group_by_dtype is None else DType(op.group_by_dtype),
            agg_dtype=None if op.agg_dtype is None else DType(op.agg_dtype),
            window=None if win is None else WindowSpec(win.wtype, win.policy, win.size, win.slide_ratio),
            selectivity=op.selectivity,
        ))
    return Query(operators=ops, edges=[tuple(e) for e in q.edges], name=q.name)


def to_cluster(c: W.Cluster):
    from repro_torch.dsps.hardware import Cluster, HardwareNode

    return Cluster(nodes=[HardwareNode(j, h.cpu, h.ram_mb, h.bandwidth_mbps, h.latency_ms) for j, h in enumerate(c)])


def cost_models(weights: Dict[str, dict], model: dict):
    """The program's ``models`` dict (metric -> (params, CostModelConfig)) over the given weights."""
    from repro_torch.core.gnn import GNNConfig
    from repro_torch.core.model import CostModelConfig

    gcfg = GNNConfig(hidden=model["hidden"], enc_layers=model["enc_layers"], update_layers=model["update_layers"],
                     readout_layers=model["readout_layers"], max_depth=model["max_depth"],
                     use_pallas=bool(model["use_pallas"]))
    return {m: (weights[m], CostModelConfig(metric=m, gnn=gcfg, n_ensemble=model["members"])) for m in model["metrics"]}


class Program:
    """One estimator serving one traffic mix."""

    def __init__(self, traffic: Traffic, weights: Dict[str, dict], model: dict, device):
        from repro_torch.core.graph import batch_graphs, build_graph
        from repro_torch.dsps.placement import Placement
        from repro_torch.serve.estimator import CostEstimator

        self.traffic = traffic
        self.metrics = tuple(model["metrics"])
        self.est = CostEstimator(cost_models(weights, model), device=device)
        # each call of the schedule's cycle, in the program's types, made once
        if traffic.entry == "score_many":
            pairs = [(to_query(q), to_cluster(c), pool) for q, c, pool in traffic.structures]
            self.args = [[(pairs[s][0], pairs[s][1], pairs[s][2][rows[0] : rows[-1] + 1])
                          for s, rows in traffic.requests(i)] for i in range(traffic.cycle())]
        else:  # the pool featurized by the program, one batched JointGraph per batch
            graphs = [build_graph(to_query(t.query), to_cluster(t.cluster), Placement.of(t.assignment))
                      for t in traffic.traces]
            batches = [batch_graphs([graphs[k] for k in ids]) for ids in traffic.batches]
            self.args = [[batches[b] for b in traffic.batch_ids(i)] for i in range(traffic.cycle())]

    def dispatch(self, i: int):
        """Call ``i`` queued on the device: a handle whose answers ``finish`` waits for."""
        args, entry = self.args[i % len(self.args)], self.traffic.entry
        if entry == "estimate":
            return self.est.estimate(args[0], self.metrics, deferred=True)
        if entry == "estimate_many":
            return self.est.estimate_many(args, self.metrics, deferred=True)
        return self.est.score_many(args, self.metrics, deferred=True)

    def finish(self, handle) -> Dict[str, np.ndarray]:
        """The call's answers: metric -> one value per item, in ``Traffic.item_ids`` order."""
        out = handle.result()
        parts: List[Dict[str, np.ndarray]] = [out] if isinstance(out, dict) else list(out)
        return {m: np.concatenate([np.asarray(p[m]) for p in parts]) for m in self.metrics}

    def close(self) -> None:
        del self.est
