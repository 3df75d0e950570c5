"""An estimator whose metrics' GNN configs differ: one ensemble stack per metric, on every path.

Metrics of hidden 16 and 24 cannot share a stack, so ``CostEstimator._stacks_for`` gives each
metric a stack of its own and every entry runs its chunks once per stack through the one launch
path.  ``estimate`` equals, bitwise, each metric's ``forward_ensemble`` voted on its own;
``score``, ``estimate_many`` and ``score_many`` (the merged forwards, not a per-request
fallback) equal per-request ``estimate`` over the broadcast batch: regression within
``rtol=1e-4, atol=1e-6``, votes equal wherever every member's logit is clear of 0 by 1e-3.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import JointGraph, batch_graphs, build_graph, build_graph_batch
from repro_torch.core.model import REGRESSION_METRICS, CostModelConfig, forward_ensemble, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.estimator import CostEstimator, graphs_to_device
from repro_torch.serve.stacking import _ensemble_vote

HIDDEN = {"latency_p": 16, "throughput": 24, "success": 16, "backpressure": 24}


@pytest.fixture(scope="module")
def estimator():
    gen = torch.Generator().manual_seed(3)
    models = {}
    for m, hidden in HIDDEN.items():
        cfg = CostModelConfig(metric=m, gnn=GNNConfig(hidden=hidden, use_pallas=True), n_ensemble=2)
        models[m] = (init_cost_model(gen, cfg), cfg)
    return CostEstimator(models, device="cpu")


def _logits(est, graphs):
    """Each metric's member outputs on a host batch, (E, B)."""
    g = graphs_to_device(graphs, "cpu")
    with torch.no_grad():
        return {m: forward_ensemble(est._params_for(m), g, est.config(m)).numpy() for m in est.metrics}


def _assert_close(got, want, logits):
    assert list(got) == list(want)
    for m in got:
        if m in REGRESSION_METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
        else:
            clear = (np.abs(logits[m]) > 1e-3).all(axis=0)
            np.testing.assert_array_equal(np.asarray(got[m])[clear], np.asarray(want[m])[clear], err_msg=m)


def _requests(seed=5, cands=(6, 3, 9, 4)):
    work = WorkloadGenerator(seed=seed)
    rng = np.random.default_rng(seed)
    pairs = [(work.query(kind=k, name=f"s{i}"), work.cluster(3 + i)) for i, k in enumerate(("linear", "two_way", "three_way"))]
    pairs.append(pairs[0])
    return [(q, c, sample_assignment_matrix(q, c, n, rng)) for (q, c), n in zip(pairs, cands)]


@pytest.mark.parametrize("path", ["estimate", "score", "estimate_many", "score_many"])
def test_differing_configs_ride_one_stack_per_metric(estimator, path):
    est = estimator
    stacks = est._stacks_for(est.metrics)
    assert [st.metrics for st in stacks] == [(m,) for m in est.metrics]
    assert est.supports_cross_query()
    traces = WorkloadGenerator(seed=11).corpus(13)
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    if path == "estimate":
        got = est.estimate(g)
        logits = _logits(est, g)
        assert list(got) == list(est.metrics)
        for m in est.metrics:
            assert np.array_equal(got[m], _ensemble_vote(logits[m], est.config(m))), m
        one = est.estimate(JointGraph(*[x[0] for x in g]))
        assert all(np.shape(v) == () for v in one.values())
        _assert_close({m: v[None] for m, v in one.items()}, {m: v[:1] for m, v in got.items()},
                      {m: v[:, :1] for m, v in logits.items()})
    elif path == "score":
        for q, c, a in _requests():
            want_g = build_graph_batch(q, c, a)
            _assert_close(est.score(q, c, a), est.estimate(want_g), _logits(est, want_g))
    elif path == "estimate_many":
        bounds = ((0, 4), (4, 4), (4, 5), (5, 13))  # an empty batch among them
        batches = [JointGraph(*[x[a:b] for x in g]) for a, b in bounds]
        for max_rows in (None, 5):
            got = est.estimate_many(batches, max_rows=max_rows, deferred=True).result()
            assert len(got) == len(batches)
            for g_, b in zip(got, batches):
                if len(b.op_x) == 0:
                    assert all(len(v) == 0 for v in g_.values())
                    continue
                _assert_close(g_, est.estimate(b), _logits(est, b))
    else:
        reqs = _requests()
        for max_rows in (None, 8):
            got = est.score_many(reqs, max_rows=max_rows)
            assert len(got) == len(reqs)
            for g_, (q, c, a) in zip(got, reqs):
                want_g = build_graph_batch(q, c, a)
                _assert_close(g_, est.estimate(want_g), _logits(est, want_g))
        assert est._merged_groups  # the merged forward answered, not a per-request fallback
