"""The merged forward's split and the row buckets of the graphed forwards (``core/gnn.py``,
``serve/graphs.py``) on the CPU.

On a GPU, ``score_many`` replays each chunk's merged forward from a CUDA graph at the chunk's row
bucket, over the stack's constants computed once, and ``estimate`` replays a batch's full-depth
scan at the batch's row bucket (the card tests in ``test_torch_cuda.py`` hold the replays).  Here,
on a DSPBench-like and a synthetic structure mix: the constants computed once give
``apply_gnn_merged``'s outputs bitwise on every chunk, the forward over them copies nothing from the
host, and a chunk padded to its bucket gives its real rows' outputs unchanged; a graph batch padded
with zero graphs to its bucket gives its real graphs' outputs unchanged; and on the CPU neither
entry opens a graph.  No JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch import nn, obs
from repro_torch.core import gnn, graph
from repro_torch.core.model import CostModelConfig, forward_ensemble, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.dsps.benchmarks import BENCHMARKS, sample_benchmark_query
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve import graphs
from repro_torch.serve.estimator import CostEstimator
from repro_torch.serve.service import PlacementService

MIXES = ("dspbench", "synthetic")


def _structures(mix: str, seed: int = 29):
    """Four (query, cluster) pairs: DSPBench's queries (3 to 5 operators) or synthetic join trees."""
    gen, rng = WorkloadGenerator(seed=seed), np.random.default_rng(seed)
    if mix == "dspbench":
        return [(sample_benchmark_query(name, rng), gen.cluster(3 + i)) for i, name in enumerate(BENCHMARKS)]
    return [(gen.query(kind=k, name=f"s{i}"), gen.cluster(4 + i))
            for i, k in enumerate(("linear", "two_way", "three_way", "three_way"))]


def _merged(mix: str, n_per: int = 75):
    """The stack, its banding and parent bound, and ``n_per`` placements of each structure."""
    pairs = _structures(mix)
    rng = np.random.default_rng(3)
    skels = graph.batch_graphs([graph.build_graph_skeleton(q, c) for q, c in pairs])
    blocks = [graph.build_a_place_batch(q, c, sample_assignment_matrix(q, c, n_per, rng)) for q, c in pairs]
    ids = np.concatenate([np.full(len(b), i, dtype=np.int64) for i, b in enumerate(blocks)])
    band = graph.exact_banding_cached(skels)
    max_parents = int(np.asarray(skels.a_flow).sum(axis=-2).max(initial=1))
    return JointGraphT(skels), band, max_parents, ids, np.concatenate(blocks)


def JointGraphT(g):
    return graph.JointGraph(*[torch.from_numpy(np.asarray(x)) for x in g])


def _params(members: int = 2, hidden: int = 16, use_pallas: bool = True):
    cfg = gnn.GNNConfig(hidden=hidden, use_pallas=use_pallas)
    gen = torch.Generator().manual_seed(11)
    return init_cost_model(gen, CostModelConfig(metric="latency_p", gnn=cfg, n_ensemble=members)), cfg


@pytest.mark.parametrize("mix", MIXES)
def test_merged_constants_once_match_the_inline_forward(mix, monkeypatch):
    """The stack's constants, computed once, give ``apply_gnn_merged``'s outputs bitwise on chunks
    of other rows; the forward over them makes no index tensor and copies nothing from the host."""
    skels, band, max_parents, ids, a_place = _merged(mix)
    params, cfg = _params()
    consts = gnn.merged_constants(skels, band, max_parents)
    assert consts.rows is not None and len(consts.levels) == len(band.levels)

    def no_copy(*a, **k):
        raise AssertionError("the per-rows forward copied from the host")

    for s, e in ((0, len(ids)), (40, 211), (170, 171)):
        sid, ap = torch.from_numpy(ids[s:e]), torch.from_numpy(a_place[s:e])
        want = gnn.apply_gnn_merged(params, skels, sid, ap, cfg, band, max_parents)
        with monkeypatch.context() as m:
            m.setattr(nn, "arrays_to_device", no_copy)
            got = gnn.apply_gnn_merged_rows(params, consts, sid, ap, cfg)
        assert got.shape == (2, e - s)
        assert torch.equal(got, want), (s, e)


@pytest.mark.parametrize("mix", MIXES)
def test_a_chunk_padded_to_its_bucket_keeps_its_real_rows(mix):
    """Pad rows (skeleton 0, placed nowhere) are finite and leave every real row's output as it
    is: the padded chunk's first ``n`` outputs equal the unpadded chunk's, for both routes."""
    skels, band, max_parents, ids, a_place = _merged(mix)
    n = len(ids)
    rows = graphs.row_bucket(n)
    assert n < rows
    sid_p, ap_p = (np.concatenate(p) for p in graphs.padded_parts(ids, a_place, rows))
    assert sid_p.shape == (rows,) and ap_p.shape == (rows,) + a_place.shape[1:]
    assert not sid_p[n:].any() and not ap_p[n:].any()
    for use_pallas in (True, False):
        params, cfg = _params(use_pallas=use_pallas)
        want = gnn.apply_gnn_merged(params, skels, torch.from_numpy(ids), torch.from_numpy(a_place), cfg,
                                    band, max_parents)
        got = gnn.apply_gnn_merged(params, skels, torch.from_numpy(sid_p), torch.from_numpy(ap_p), cfg,
                                   band, max_parents)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[:, :n], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,rows", [(1, 256), (255, 256), (256, 256), (257, 512), (3071, 3072)])
def test_row_bucket(n, rows):
    assert graphs.row_bucket(n) == rows


def test_cpu_score_many_runs_eager():
    """On the CPU ``score_many`` runs ``apply_gnn_merged`` unpadded: its ``gnn.forward`` spans say
    ``graph="eager"`` and count real rows only, the group holds no constants and no graph, and
    the graph counters do not move."""
    cfg = gnn.GNNConfig(hidden=16, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg, n_ensemble=2)),
                  CostModelConfig(metric=m, gnn=cfg, n_ensemble=2)) for m in ("latency_p", "success")}
    est = CostEstimator(models, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(q, c, sample_assignment_matrix(q, c, 30, rng)) for q, c in _structures("synthetic")]
    before = {k: v for k, v in obs.counters().items() if k.startswith("cache.graph.")}
    est.score_many(reqs)
    with profile(activities=[ProfilerActivity.CPU]):
        est.score_many(reqs)
    (group,) = est._merged_groups.values()
    assert group.consts is None and not group.graphs
    fw = [r.attrs for r in obs.records() if r.name == "gnn.forward"]
    levels = sum(e - s for _, (s, e), _ in group.banding.levels)
    assert [a["graph"] for a in fw] == ["eager"]
    assert fw[0]["rows3"] == sum(len(a) for _, _, a in reqs) * levels
    assert {k: v for k, v in obs.counters().items() if k.startswith("cache.graph.")} == before


def _graph_batch(b: int) -> graph.JointGraph:
    """``b`` placed synthetic graphs: 24 distinct ones, repeated."""
    traces = WorkloadGenerator(seed=31).corpus(24)
    one = [graph.build_graph(t.query, t.cluster, t.placement) for t in traces]
    return graph.batch_graphs([one[i % len(one)] for i in range(b)])


@pytest.mark.parametrize("b", [1, 255, 256, 257])
def test_a_graph_batch_padded_to_its_bucket_keeps_its_real_graphs(b):
    """``estimate``'s pad on a GPU: a batch of ``b`` graphs padded with zero graphs (no operator,
    host, edge or placement; ``graphs.zero_padded``) to ``row_bucket(b)`` gives finite outputs, and
    its first ``b`` columns equal the unpadded batch's full-depth scan, on both routes."""
    host = _graph_batch(b)
    rows = graphs.row_bucket(b)
    padded = graph.JointGraph(*[np.concatenate(p) for p in graphs.zero_padded(host, rows)])
    assert all(x.shape == (rows,) + y.shape[1:] and x.dtype == y.dtype for x, y in zip(padded, host))
    assert not any(x[b:].any() for x in padded)
    for use_pallas in (False, True):
        params, cfg = _params(use_pallas=use_pallas)
        mcfg = CostModelConfig(metric="latency_p", gnn=cfg, n_ensemble=2)
        want = forward_ensemble(params, JointGraphT(host), mcfg)
        got = forward_ensemble(params, JointGraphT(padded), mcfg)
        assert got.shape == (2, rows) and torch.isfinite(got).all()
        torch.testing.assert_close(got[:, :b], want, rtol=1e-5, atol=1e-6)


def test_cpu_estimate_runs_eager():
    """On the CPU ``estimate`` runs the full-depth scan eagerly on the batch as it is: its
    ``gnn.forward`` span says ``graph="eager"`` and counts the real graphs' rows only, the
    estimator opens no graph and no pool, and the graph counters do not move."""
    params, cfg = _params()
    est = CostEstimator({"latency_p": (params, CostModelConfig(metric="latency_p", gnn=cfg, n_ensemble=2))},
                        device="cpu")
    host = _graph_batch(40)
    before = {k: v for k, v in obs.counters().items() if k.startswith("cache.graph.")}
    first = est.estimate(host)
    with profile(activities=[ProfilerActivity.CPU]):
        again = est.estimate(host)
    fw = [r.attrs for r in obs.records() if r.name == "gnn.forward"]
    assert [a["graph"] for a in fw] == ["eager"]
    assert fw[0]["rows3"] == cfg.max_depth * host.op_mask.size
    assert not est._estimate_graphs and est._graph_pool is None
    assert {k: v for k, v in obs.counters().items() if k.startswith("cache.graph.")} == before
    assert first["latency_p"].shape == (40,) and np.array_equal(first["latency_p"], again["latency_p"])


@pytest.mark.parametrize("max_batch,buckets", [(1024, [256, 512, 768, 1024]), (1000, [256, 512, 768, 1024]),
                                               (512, [256, 512])])
def test_service_warm_runs_each_row_bucket_once(max_batch, buckets, monkeypatch):
    """``PlacementService.warm`` runs the merged drain of its mix once at every row bucket a
    merged chunk of up to ``max_batch`` rows can take, each in one chunk, so a GPU captures every
    graph there and none in a serving drain."""
    params, cfg = _params()
    est = CostEstimator({"latency_p": (params, CostModelConfig(metric="latency_p", gnn=cfg, n_ensemble=2))},
                        device="cpu")
    merged = []
    monkeypatch.setattr(est, "score", lambda *args, **kwargs: None)
    monkeypatch.setattr(est, "score_many", lambda items, metrics, max_rows: merged.append(
        (sum(len(a) for _, _, a in items), len(items), max_rows)))
    svc = PlacementService(est, max_batch=max_batch, auto_start=False)
    svc.warm(_structures("synthetic"), max_cands=256)
    assert [graphs.row_bucket(n) for n, _, _ in merged] == buckets
    assert all(n <= max_batch and k == 4 and m == max_batch for n, k, m in merged)
