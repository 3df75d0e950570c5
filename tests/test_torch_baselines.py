"""The port's baselines and ablations against the JAX package, on the CPU.

Covered: the Exp-7b traditional-MP forward (``apply_gnn_traditional``,
``forward_ensemble(traditional_mp=True)``), its gradient and a training run;
the flat-vector baseline (features, forward, training, prediction,
artifacts); the estimator over a JAX-written traditional bundle; the pinned
rescheduler and benchmark queries.  The stages of ``launch/train.py`` that
train these models are held in ``test_torch_stages.py`` (a file of their
own, so that parallel test workers share the load).  Every comparison runs on shared parameters (JAX-made, carried across with
``params_from_numpy``) at hidden 16.  Tolerances: forwards ``rtol=atol=1e-4``
(as the other GNN forwards); gradients 1e-5; a training run's per-epoch
losses ``rtol=1e-4`` and its final params ``atol=1e-4``; flat features
exactly; serving answers ``rtol=1e-4, atol=1e-6`` with votes equal where
every member's logit is clear of 0.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core.flat_vector as jflat
import repro.core.gnn as jgnn
import repro.core.model as jmodel
import repro.launch.artifacts as jartifacts
import repro.serve as jserve
import repro.training as jtraining
import repro.training.loop as jloop
from repro.core.graph import batch_graphs as jax_batch_graphs, build_graph as jax_build_graph
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.dsps.placement import Placement
from repro.placement import sample_assignment_matrix as jax_sample
from repro_torch import core, nn, obs
from repro_torch.core import flat_vector, gnn, graph, model
from repro_torch.core.model import CLASSIFICATION_METRICS, REGRESSION_METRICS
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.seg_gather import ops as seg_ops
from repro_torch.launch import artifacts
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator
from repro_torch.training import batching, loop

H = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Hidden-16 tensors gain nothing from intra-op threads, and the suite's
    parallel workers share the machine's cores; restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _as_torch(g):
    return graph.JointGraph(*[torch.from_numpy(np.ascontiguousarray(x)) for x in g])


def _assert_trees_close(got, want, **tol):
    got_leaves, want_leaves = nn.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def _traditional(metric="latency_p", members=3, use_pallas=False, seed=0):
    """JAX-made traditional-MP ensemble params and both packages' configs."""
    jcfg = jmodel.CostModelConfig(metric=metric, n_ensemble=members, traditional_mp=True,
                                  gnn=jgnn.GNNConfig(hidden=H, use_pallas=use_pallas))
    cfg = model.CostModelConfig(metric=metric, n_ensemble=members, traditional_mp=True,
                                gnn=gnn.GNNConfig(hidden=H, use_pallas=use_pallas))
    return _np_tree(jmodel.init_cost_model(jax.random.PRNGKey(seed), jcfg)), jcfg, cfg


def _corpus_batch(seed=3, n=6):
    traces = JaxGenerator(seed=seed).corpus(n)
    return jax_batch_graphs([jax_build_graph(t.query, t.cluster, t.placement) for t in traces])


# -- the traditional-MP forward ---------------------------------------------------------

# (use_pallas, JAX lowering): the plain path, and the kernel path through the
# JAX package's jnp oracle and through the Pallas interpreter (the kernel body)
ROUTES = [(False, "ref"), (True, "ref"), (True, "interpret")]


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
def test_traditional_forward_matches_jax(use_pallas, lowering, members, monkeypatch):
    """``apply_gnn_traditional`` (every member and graph in one call) against
    the JAX package's per-member, per-graph ``vmap``; ``forward_ensemble``
    with ``traditional_mp`` against the JAX one, which ignores a banding."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1" if lowering == "interpret" else "0")
    p, jcfg, cfg = _traditional(members=members, use_pallas=use_pallas, seed=members)
    g = _corpus_batch()
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tp, tg = nn.params_from_numpy(p), _as_torch(g)
    per_graph = jax.vmap(lambda pp: jax.vmap(lambda gg: jgnn.apply_gnn_traditional(pp, gg, jcfg.gnn))(jg))
    want = np.asarray(jax.jit(per_graph)(p))  # (E, B, 1)
    got = gnn.apply_gnn_traditional(tp, tg, cfg.gnn)
    assert got.shape == want.shape == (members, 6, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = gnn.apply_gnn_traditional(tp, graph.JointGraph(*[x[2] for x in tg]), cfg.gnn)  # a single graph
    np.testing.assert_allclose(one.numpy(), want[:, 2], **TOL)
    want_e = np.asarray(jmodel.forward_ensemble(p, jg, jcfg))
    for banding in (None, graph.exact_banding(graph.JointGraph(*g))):
        got_e = model.forward_ensemble(tp, tg, cfg, banding)
        assert got_e.shape == (members, 6)
        np.testing.assert_allclose(got_e.numpy(), want_e, **TOL)


def _count_calls(monkeypatch):
    """Count wrapper calls (the CPU runs the plain versions: no launches)."""
    wrapped = {
        "banked_mlp": (bank_ops, "banked_mlp_slotted"),
        "mp_update": (mp_ops, "mp_update"),
        "mp_sweep": (sweep_ops, "mp_sweep"),
        "gather_sum": (seg_ops, "gather_sum"),
        "segment_sum": (seg_ops, "segment_sum"),
    }
    counts = dict.fromkeys(wrapped, 0)

    def counting(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)

        return wrapper

    for name, (mod, attr) in wrapped.items():
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    return counts


@pytest.mark.parametrize("members,n_rounds", [(1, 3), (3, 3), (3, 1)])
def test_traditional_forward_calls_only_banked_mlp(members, n_rounds, monkeypatch):
    """Two encoder calls and two update calls a round, whatever the member
    count; no stage-3 or merged-engine wrapper."""
    p, _, cfg = _traditional(members=members, use_pallas=True)
    tg = _as_torch(_corpus_batch(n=4))
    launches = obs.counters().get("banked_mlp_slotted.launches", 0)
    counts = _count_calls(monkeypatch)
    gnn.apply_gnn_traditional(nn.params_from_numpy(p), tg, cfg.gnn, n_rounds=n_rounds)
    assert counts == {"banked_mlp": 2 + 2 * n_rounds, "mp_update": 0, "mp_sweep": 0, "gather_sum": 0,
                      "segment_sum": 0}
    assert obs.counters().get("banked_mlp_slotted.launches", 0) == launches  # the CPU launches nothing


def test_traditional_three_layer_bank_raises_under_use_pallas():
    """The kernel fuses two layers: a 3-layer update bank raises, never runs
    the plain path instead."""
    deep = gnn.GNNConfig(hidden=H, update_layers=3, use_pallas=True)
    cfg = model.CostModelConfig(gnn=deep, n_ensemble=1, traditional_mp=True)
    params = model.init_cost_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="exactly two"):
        model.forward_ensemble(params, _as_torch(_corpus_batch(n=3)), cfg)


def _banded_batch(seed=14, n=24):
    traces = JaxGenerator(seed=seed).corpus(n)
    ds = jtraining.dataset_from_traces(traces, "latency_p")
    ds, buckets = jtraining.bucket_dataset(ds, exact=True)
    b = max(buckets, key=len)
    sub = ds.select(slice(b.start, b.stop))
    return sub.graphs, sub.labels, b.banding


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("metric", ["latency_p", "success"])
def test_traditional_ensemble_loss_grad_matches_jax(use_pallas, metric, monkeypatch):
    """``ensemble_loss`` of a traditional ensemble and its gradient against
    ``jax.grad`` on one banded batch (the JAX kernel ops under their jnp
    oracle, as the JAX package's own gradient tests run them)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")
    g, y, band = _banded_batch()
    if metric == "success":
        y = (y > np.median(y)).astype(np.float32)
    p, jcfg, cfg = _traditional(metric, members=2, use_pallas=use_pallas, seed=2)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    want_loss, want = jax.jit(jax.value_and_grad(lambda pp: jmodel.ensemble_loss(pp, jg, jnp.asarray(y), jcfg, band)))(p)
    tg, ty = batching.batch_to_device(g, y, "cpu")
    loss, grads = loop.loss_and_grads(nn.params_from_numpy(p), tg, ty, cfg, graph.exact_banding(graph.JointGraph(*g)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_trees_close(grads, want, rtol=1e-5, atol=1e-5)
    assert all(float(x.abs().max()) > 0 for x in nn.tree_leaves(grads))


def _one_structure_corpus(gen_cls, n=40, seed=5):
    """Linear queries of one shape: the JAX reference compiles its step once."""
    gen, out = gen_cls(seed=seed), []
    while len(out) < n:
        t = gen.trace(kind="linear")
        if len(t.query.operators) == 3:
            out.append(t)
    return out


def test_traditional_train_cost_model_matches_jax(monkeypatch):
    """A 3-epoch run of a traditional ensemble through the bucketed, banded
    loop: the JAX package's history and final params."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")
    train = dict(epochs=3, batch_size=8, lr=3e-3, exact_banding=True)
    jt, pt = _one_structure_corpus(JaxGenerator), _one_structure_corpus(WorkloadGenerator)
    jtr, jva, _ = jtraining.split_dataset(jtraining.dataset_from_traces(jt, "latency_p"), seed=7)
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(pt, "latency_p"), seed=7)
    p0, jcfg, cfg = _traditional(members=2)
    theirs = jtraining.train_cost_model(jtr, jva, jcfg, jtraining.TrainConfig(**train), init_params=p0)
    ours = loop.train_cost_model(tr, va, cfg, loop.TrainConfig(**train), init_params=nn.params_from_numpy(p0),
                                 device="cpu")
    assert len(ours.history) == len(theirs.history) == 3 and ours.steps == theirs.steps
    for a, b in zip(ours.history, theirs.history):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=1e-4)
    assert ours.history[-1]["train_loss"] < ours.history[0]["train_loss"]
    _assert_trees_close(ours.params, theirs.params, rtol=0, atol=1e-4)


# -- the flat-vector baseline -----------------------------------------------------------


def test_featurize_flat_matches_jax_exactly():
    ours, theirs = WorkloadGenerator(seed=4).corpus(48), JaxGenerator(seed=4).corpus(48)
    got, want = flat_vector.featurize_flat_traces(ours), jflat.featurize_flat_traces(theirs)
    assert got.shape == want.shape == (48, core.FLAT_DIM) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    t = ours[5]
    np.testing.assert_array_equal(core.featurize_flat(t.query, t.cluster, t.placement), want[5])
    assert core.FlatVectorConfig() == flat_vector.FlatVectorConfig(hidden=128, n_layers=3, task="regression")


def _flat_data(task, n=90, seed=0):
    """Flat vectors of a corpus and one metric's labels, split 80/10/10."""
    traces = JaxGenerator(seed=seed).corpus(n)
    x = jflat.featurize_flat_traces(traces)
    metric = "latency_p" if task == "regression" else "success"
    y = jmodel.label_array(traces, metric)
    tr, va, te = jtraining.split_indices(n, seed=7)
    return x, y, tr, va, te


def test_forward_flat_matches_jax():
    cfg = jflat.FlatVectorConfig(hidden=32)
    p = _np_tree(jflat.init_flat_model(jax.random.PRNGKey(3), cfg))
    x, _, _, _, _ = _flat_data("regression", n=20)
    want = np.asarray(jflat.forward_flat(p, jnp.asarray(x)))
    got = core.forward_flat(nn.params_from_numpy(p), torch.from_numpy(x))
    assert got.shape == want.shape == (20,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ours = core.init_flat_model(torch.Generator().manual_seed(0), flat_vector.FlatVectorConfig(hidden=32))
    assert [tuple(t.shape) for t in nn.tree_leaves(ours)] == [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(p)]


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_train_flat_model_matches_jax(task, monkeypatch):
    """The port's loop from JAX's own init (``init_flat_model`` patched):
    the same batches, updates and early stopping give JAX's best params."""
    x, y, tr, va, _ = _flat_data(task)
    cfg_j, cfg = jflat.FlatVectorConfig(hidden=32, task=task), flat_vector.FlatVectorConfig(hidden=32, task=task)
    tcfg = dict(epochs=5, batch_size=16, lr=3e-3, seed=4)
    _, init_key = jax.random.split(jax.random.PRNGKey(tcfg["seed"]))  # as JAX's train_flat_model draws it
    p0 = _np_tree(jflat.init_flat_model(init_key, cfg_j))
    monkeypatch.setattr(loop, "init_flat_model", lambda gen, c: nn.params_from_numpy(p0))
    want = jloop.train_flat_model(x[tr], y[tr], x[va], y[va], cfg_j, jloop.TrainConfig(**tcfg))
    got = loop.train_flat_model(x[tr], y[tr], x[va], y[va], cfg, loop.TrainConfig(**tcfg), device="cpu")
    _assert_trees_close(got, want, rtol=0, atol=1e-4)
    assert not all(np.array_equal(a.numpy(), b) for a, b in zip(nn.tree_leaves(got), jax.tree_util.tree_leaves(p0)))
    assert all(t.device.type == "cpu" for t in nn.tree_leaves(got))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_predict_flat_matches_jax(task):
    x, _, _, _, te = _flat_data(task, n=60)
    p = _np_tree(jflat.init_flat_model(jax.random.PRNGKey(5), jflat.FlatVectorConfig(task=task)))
    want = jloop.predict_flat(p, x[te], task)
    got = loop.predict_flat(nn.params_from_numpy(p), x[te], task, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    if task == "regression":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        raw = np.asarray(jflat.forward_flat(p, jnp.asarray(x[te])))
        clear = np.abs(raw) > 1e-4
        np.testing.assert_array_equal(got[clear], want[clear])


def test_flat_artifacts_cross_between_packages(tmp_path, monkeypatch):
    """A flat model the port stores loads in the JAX package, and the reverse:
    the same manifest, the same params."""
    monkeypatch.setattr(artifacts, "ROOT", str(tmp_path))
    monkeypatch.setattr(jartifacts, "ROOT", str(tmp_path))
    cfg_j = jflat.FlatVectorConfig(hidden=24, n_layers=4, task="classification")
    theirs = _np_tree(jflat.init_flat_model(jax.random.PRNGKey(1), cfg_j))
    jartifacts.save_flat_model("flat_jax", theirs, cfg_j)
    got, cfg = artifacts.load_flat_model("flat_jax")
    assert cfg == flat_vector.FlatVectorConfig(hidden=24, n_layers=4, task="classification")
    _assert_trees_close(got, theirs, rtol=0, atol=0)
    ours = core.init_flat_model(torch.Generator().manual_seed(2), cfg)
    artifacts.save_flat_model("flat_torch", ours, cfg, extra={"note": 1})
    back, back_cfg = jartifacts.load_flat_model("flat_torch")
    assert back_cfg == cfg_j and artifacts.exists("flat", "flat_torch")
    _assert_trees_close(ours, back, rtol=0, atol=0)
    manifests = [json.load(open(os.path.join(tmp_path, "flat", n, "step_0000000000", "manifest.json")))
                 for n in ("flat_jax", "flat_torch")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[1]["extra"] == {"hidden": 24, "n_layers": 4, "task": "classification", "note": 1}


# -- serving a traditional bundle -------------------------------------------------------

BUNDLE_METRICS = ("throughput", "latency_p", "success")


@pytest.fixture(scope="module")
def traditional_bundle(tmp_path_factory):
    """A JAX-written bundle of traditional-MP ensembles; both estimators."""
    models = {}
    for i, m in enumerate(BUNDLE_METRICS):
        cfg = jmodel.CostModelConfig(metric=m, n_ensemble=2, traditional_mp=True,
                                     gnn=jgnn.GNNConfig(hidden=H, use_pallas=True))
        models[m] = (jmodel.init_cost_model(jax.random.PRNGKey(10 + i), cfg), cfg)
    d = str(tmp_path_factory.mktemp("traditional") / "b")
    jserve.CostModelBundle(models).save(d)
    ours = CostEstimator.from_bundle(CostModelBundle.load(d), device="cpu")
    return models, jserve.CostEstimator(models), ours


def _logits(models, graphs):
    g = jax.tree_util.tree_map(jnp.asarray, graphs)
    return {m: np.asarray(jmodel.forward_ensemble(models[m][0], g, models[m][1])) for m in CLASSIFICATION_METRICS
            if m in models}


def _assert_same(got, want, raw_logits):
    assert set(got) == set(want)
    for m in got:
        if m in REGRESSION_METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
        else:
            clear = (np.abs(raw_logits[m]) > 1e-3).all(axis=0)
            np.testing.assert_array_equal(np.asarray(got[m])[clear], np.asarray(want[m])[clear], err_msg=m)


def _requests(seed=71, cands=7):
    gen = JaxGenerator(seed=seed)
    rng = np.random.default_rng(seed)
    pairs = [(gen.query(kind=k, name=f"t{i}"), gen.cluster(3 + i)) for i, k in enumerate(("linear", "two_way", "three_way"))]
    pairs.append(pairs[0])
    return [(q, c, jax_sample(q, c, cands, rng, max_tries_factor=400)) for q, c in pairs]


def _placed_graphs(q, c, a):
    return jax_batch_graphs([jax_build_graph(q, c, Placement.of(r)) for r in a])


@pytest.mark.parametrize("path", ["estimate", "score", "optimize", "estimate_many", "score_many"])
def test_traditional_bundle_serves_like_jax(traditional_bundle, path, monkeypatch):
    """Each facade path over one JAX-written traditional bundle: the JAX
    estimator's answers; the cross-query paths answer per request."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")
    models, jest, est = traditional_bundle
    assert not est.supports_cross_query() and not jest.supports_cross_query()
    reqs = _requests()
    if path == "estimate":
        g = _corpus_batch(seed=9, n=7)
        _assert_same(est.estimate(graph.JointGraph(*g)), jest.estimate(g), _logits(models, g))
    elif path == "score":
        q, c, a = reqs[1]
        _assert_same(est.score(q, c, a), jest.score(q, c, a), _logits(models, _placed_graphs(q, c, a)))
        _assert_same(est.score(q, c, a, deferred=True).result(), jest.score(q, c, a),
                     _logits(models, _placed_graphs(q, c, a)))
    elif path == "optimize":
        q, c, _ = reqs[2]
        ours = est.optimize(q, c, "latency_p", k=16, rng=np.random.default_rng(0))
        theirs = jest.optimize(q, c, "latency_p", k=16, rng=np.random.default_rng(0))
        assert ours.placement.assignment == theirs.placement.assignment
        assert ours.n_candidates == theirs.n_candidates
        np.testing.assert_allclose(ours.scores, theirs.scores, rtol=1e-4, atol=1e-6)
    elif path == "estimate_many":
        traces = JaxGenerator(seed=12).corpus(9)
        batches = [jax_batch_graphs([jax_build_graph(t.query, t.cluster, t.placement) for t in traces[a:b]])
                   for a, b in ((0, 4), (4, 5), (5, 9))]
        want = jest.estimate_many(batches)
        for got in (est.estimate_many([graph.JointGraph(*b) for b in batches]),
                    est.estimate_many([graph.JointGraph(*b) for b in batches], max_rows=2, deferred=True).result()):
            for g_, w_, b in zip(got, want, batches):
                _assert_same(g_, w_, _logits(models, b))
    else:
        want = jest.score_many(reqs)
        for got in (est.score_many(reqs), est.score_many(reqs, deferred=True).result()):
            assert len(got) == len(reqs)
            for g_, w_, (q, c, a) in zip(got, want, reqs):
                _assert_same(g_, w_, _logits(models, _placed_graphs(q, c, a)))
        assert not est._merged_groups  # no merged forward was built


class _Recorder:
    def __init__(self):
        self.calls = []

    def before(self, kind, n):
        self.calls.append(("before", kind, n))

    def after(self, kind, out):
        self.calls.append(("after", kind))


def test_traditional_scoring_hooks_fire_once_and_empty_raises(traditional_bundle):
    """Scoring a traditional bundle goes through ``estimate`` on the
    bucket-padded broadcast batch: its hooks fire once, as ``estimate``, in
    both packages; an empty request raises ``ValueError``."""
    models, jest, est = traditional_bundle
    q, c, a = _requests()[1]
    seen = []
    for e in (est, jest):
        rec = _Recorder()
        e.add_hook(rec)
        try:
            e.score(q, c, a[:5])
            with pytest.raises(ValueError):
                e.score(q, c, a[:0])
        finally:
            e.remove_hook(rec)
        seen.append(rec.calls)
    assert seen[0] == seen[1] == [("before", "estimate", 8), ("after", "estimate")]


# -- the pinned copies: the online-monitoring rescheduler and the benchmark queries ------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_monitoring_run_matches_jax(seed):
    """The Exp-2b rescheduler from the heuristic placement of a seeded query
    towards a fraction of its simulated latency: the same
    ``MonitoringResult`` in both packages."""
    import dataclasses

    import repro.dsps.simulator as jsimulator
    import repro.placement as jplacement
    from repro_torch import placement
    from repro_torch.dsps import simulator
    from repro_torch.placement.enumerate import heuristic_placement

    results = []
    for gen_cls, pl, heuristic, sim in ((WorkloadGenerator, placement, heuristic_placement, simulator),
                                        (JaxGenerator, jplacement, jplacement.heuristic_placement, jsimulator)):
        gen = gen_cls(seed=40 + seed)
        q = gen.query(kind=("linear", "two_way", "three_way")[seed], name=f"mon{seed}")
        c = gen.cluster(4 + seed)
        initial = heuristic(q, c)
        target = 0.7 * sim.simulate(q, c, initial).latency_p
        res = pl.online_monitoring_run(q, c, initial, target, rng=np.random.default_rng(seed))
        assert type(res).__name__ == "MonitoringResult"
        results.append(dataclasses.asdict(res))
    assert results[0] == results[1]
    assert results[0]["steps"][0] == results[0]["initial_latency"]


@pytest.mark.parametrize("name", ["advertisement", "spike_detection", "smart_grid_global", "smart_grid_local"])
def test_sample_benchmark_query_matches_jax(name):
    """The unseen benchmark queries of Exps 3-6: the same queries from the
    same draws, each valid for the simulator in both packages."""
    import repro.dsps.benchmarks as jbenchmarks
    from repro_torch.dsps import benchmarks

    rng_ours, rng_theirs = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        ours = benchmarks.sample_benchmark_query(name, rng_ours)
        theirs = jbenchmarks.sample_benchmark_query(name, rng_theirs)
        assert ours.describe() == theirs.describe() and ours.name == theirs.name == name
        assert ours.edges == theirs.edges and ours.max_depth() == theirs.max_depth()
