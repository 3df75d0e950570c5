"""The port's serving path against the JAX package, over one JAX-written bundle.

The JAX package writes a ``use_pallas=True`` bundle of all five metrics; the
port loads it unchanged, and ``estimate`` / ``proba`` / ``score`` /
``optimize`` must agree between the packages: regression costs within
``rtol=1e-4``, classification votes equal wherever every member's logit is
clear of the threshold, and the same chosen placement.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core as jcore
import repro.serve as jserve
from repro.core.graph import batch_graphs as jax_batch_graphs, build_graph as jax_build_graph
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.dsps.placement import Placement
from repro.placement import sample_assignment_matrix as jax_sample
from repro_torch.core.graph import JointGraph
from repro_torch.core.model import ALL_METRICS, CLASSIFICATION_METRICS, REGRESSION_METRICS
from repro_torch.serve.bundle import BundleIntegrityError, BundleVersionError, CostModelBundle
from repro_torch.serve.estimator import CostEstimator

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_models():
    models = {}
    for i, m in enumerate(ALL_METRICS):
        cfg = jcore.CostModelConfig(metric=m, n_ensemble=2, gnn=jcore.GNNConfig(hidden=16, use_pallas=True))
        models[m] = (jcore.init_cost_model(jax.random.PRNGKey(i), cfg), cfg)
    return models


@pytest.fixture(scope="module")
def bundle_dir(jax_models, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bundle") / "b")
    jserve.CostModelBundle(jax_models, meta={"corpus_fingerprint": "abc"}).save(d)
    return d


@pytest.fixture(scope="module")
def estimators(jax_models, bundle_dir):
    ours = CostEstimator.from_bundle(CostModelBundle.load(bundle_dir), device="cpu")
    return jserve.CostEstimator(jax_models), ours


def _assert_same(got, want, raw_logits=None):
    """Regression within rtol=1e-4; votes equal where every |logit| > 1e-3."""
    assert set(got) == set(want)
    for m in got:
        if m in REGRESSION_METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
        else:
            clear = np.ones(np.shape(want[m]), bool) if raw_logits is None else (np.abs(raw_logits[m]) > 1e-3).all(axis=0)
            np.testing.assert_array_equal(np.asarray(got[m])[clear], np.asarray(want[m])[clear], err_msg=m)


def _logits(jax_models, g):
    return {
        m: np.asarray(jcore.forward_ensemble(jax_models[m][0], g, jax_models[m][1]))
        for m in CLASSIFICATION_METRICS
    }


def test_bundle_loads_unchanged(jax_models, bundle_dir):
    b = CostModelBundle.load(bundle_dir, verify=True)
    assert b.metrics == tuple(jax_models) and b.meta == {"corpus_fingerprint": "abc"}
    for m, (params, cfg) in jax_models.items():
        assert b.config(m).gnn.use_pallas and b.config(m).n_ensemble == cfg.n_ensemble
        want = np.asarray(params["op_upd"]["layers"][1]["w"])
        np.testing.assert_array_equal(b.params(m)["op_upd"]["layers"][1]["w"].numpy(), want)
    eager = CostModelBundle.load(bundle_dir, lazy=False)
    assert isinstance(eager.models, dict) and eager.metrics == b.metrics


def test_estimate_and_proba_match_jax(jax_models, estimators):
    jest, est = estimators
    traces = JaxGenerator(seed=3).corpus(9)
    g = jax_batch_graphs([jax_build_graph(t.query, t.cluster, t.placement) for t in traces])
    logits = _logits(jax_models, jax.tree_util.tree_map(jnp.asarray, g))
    want = jest.estimate(g)
    _assert_same(est.estimate(JointGraph(*g)), want, logits)
    _assert_same(est.estimate(traces, deferred=True).result(), want, logits)
    np.testing.assert_allclose(est.proba(JointGraph(*g), "success"), jest.proba(g, "success"), rtol=1e-4, atol=1e-6)


def test_score_and_optimize_match_jax(jax_models, estimators):
    jest, est = estimators
    gen = JaxGenerator(seed=33)
    q, c = gen.query(kind="two_way", name="parity"), gen.cluster(6)
    a = jax_sample(q, c, 13, np.random.default_rng(11))
    g = jax_batch_graphs([jax_build_graph(q, c, Placement.of(r)) for r in a])
    logits = _logits(jax_models, jax.tree_util.tree_map(jnp.asarray, g))
    _assert_same(est.score(q, c, a), jest.score(q, c, a), logits)
    r_ours = est.optimize(q, c, "latency_p", k=16, rng=np.random.default_rng(0))
    r_jax = jest.optimize(q, c, "latency_p", k=16, rng=np.random.default_rng(0))
    assert r_ours.placement.assignment == r_jax.placement.assignment
    assert r_ours.n_candidates == r_jax.n_candidates
    np.testing.assert_allclose(r_ours.scores, r_jax.scores, rtol=1e-4, atol=1e-6)


@pytest.fixture(params=["ref", "interpret"])
def lowering(request, monkeypatch):
    """The JAX package's two CPU lowerings: its jnp oracles and the Pallas
    interpreter running the kernel bodies (mp_sweep, seg_gather, banked_mlp)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1" if request.param == "interpret" else "0")
    return request.param


def test_estimate_many_matches_jax(jax_models, estimators, lowering):
    """Four batches of different structures and an empty one, merged: the
    same answers as the JAX package's ``estimate_many`` and as the port's own
    per-batch ``estimate``, in one chunk and in several."""
    jest, est = estimators
    traces = JaxGenerator(seed=61).corpus(14)
    cuts = [(0, 4), (4, 5), (5, 5), (5, 11), (11, 14)]
    batches = [jax_batch_graphs([jax_build_graph(t.query, t.cluster, t.placement) for t in traces[max(a, 0):b]])
               if b > a else None for a, b in cuts]
    batches[2] = type(batches[0])(*[np.asarray(x)[:0] for x in batches[0]])  # an empty batch
    want = jest.estimate_many(batches)
    mine = [JointGraph(*b) for b in batches]
    logits = _logits(jax_models, jax.tree_util.tree_map(jnp.asarray, jax_batch_graphs(
        [jax_build_graph(t.query, t.cluster, t.placement) for t in traces])))
    serial = [est.estimate(g) if len(g.op_x) else None for g in mine]
    for got in (est.estimate_many(mine), est.estimate_many(mine, max_rows=4), est.estimate_many(mine, deferred=True).result()):
        assert len(got) == len(batches)
        for g_, w_, s_, (lo, hi) in zip(got, want, serial, cuts):
            if s_ is None:
                assert all(v.shape == (0,) for v in g_.values())
                continue
            _assert_same(g_, w_, {m: v[:, lo:hi] for m, v in logits.items()})
            _assert_same(g_, s_)


def _mixed_requests(seed=67, cands=6):
    """Five requests over four distinct (query, cluster) structures."""
    gen = JaxGenerator(seed=seed)
    rng = np.random.default_rng(seed)
    pairs = [(gen.query(kind=k, name=f"mix{i}"), gen.cluster(3 + i)) for i, k in enumerate(("linear", "two_way", "three_way", "two_way"))]
    pairs.append(pairs[1])  # a second request on one structure
    return [(q, c, jax_sample(q, c, cands, rng, max_tries_factor=400)) for q, c in pairs]


def test_score_many_matches_jax(jax_models, estimators, lowering):
    """A mixed stream through the merged engine: the JAX package's
    ``score_many`` answers, the port's per-request ``score``, in one chunk
    and in several, with and without caller-computed keys."""
    from repro_torch.core.graph import skeleton_cache_key

    jest, est = estimators
    reqs = _mixed_requests()
    want = jest.score_many(reqs)
    g = jax_batch_graphs([jax_build_graph(q, c, Placement.of(r)) for q, c, a in reqs for r in a])
    logits = _logits(jax_models, jax.tree_util.tree_map(jnp.asarray, g))
    offsets = np.cumsum([0] + [len(a) for _, _, a in reqs])
    serial = [est.score(q, c, a) for q, c, a in reqs]
    keys = [skeleton_cache_key(q, c) for q, c, _ in reqs]
    runs = (est.score_many(reqs), est.score_many(reqs, max_rows=8, keys=keys), est.score_many(reqs, deferred=True).result())
    for got in runs:
        assert len(got) == len(reqs)
        for i, (g_, w_, s_) in enumerate(zip(got, want, serial)):
            lo = {m: v[:, offsets[i] : offsets[i + 1]] for m, v in logits.items()}
            _assert_same(g_, w_, lo)
            _assert_same(g_, s_, lo)
    assert len(est._merged_groups) == 1  # one drain mix, built once


def _tamper(directory, mutate):
    p = os.path.join(directory, "step_0000000000", "manifest.json")
    with open(p) as f:
        manifest = json.load(f)
    mutate(manifest["extra"])
    with open(p, "w") as f:
        json.dump(manifest, f)


def test_incompatible_or_corrupt_bundles_raise(jax_models, tmp_path):
    one = {"latency_p": jax_models["latency_p"]}
    d = str(tmp_path / "schema")
    jserve.CostModelBundle(one).save(d)
    _tamper(d, lambda extra: extra.update(schema_version=extra["schema_version"] + 1))
    with pytest.raises(BundleVersionError, match="schema_version"):
        CostModelBundle.load(d)
    d2 = str(tmp_path / "layout")
    jserve.CostModelBundle(one).save(d2)
    _tamper(d2, lambda extra: extra["layout"]["slot_ranges"][0].__setitem__(2, 4))
    with pytest.raises(BundleVersionError, match="slot layout"):
        CostModelBundle.load(d2)
    d3 = str(tmp_path / "corrupt")
    jserve.CostModelBundle(one).save(d3)
    with open(os.path.join(d3, "step_0000000000", "arrays.npz"), "r+b") as f:
        f.truncate(100)
    with pytest.raises(BundleIntegrityError):
        CostModelBundle.load(d3, verify=True)


def test_provenance_mismatch_warns_or_raises(bundle_dir):
    b = CostModelBundle.load(bundle_dir)
    with pytest.warns(UserWarning, match="provenance"):
        CostEstimator.from_bundle(b, corpus_fingerprint="other", device="cpu")
    with pytest.raises(BundleVersionError, match="provenance"):
        CostEstimator.from_bundle(b, corpus_fingerprint="other", strict_provenance=True, device="cpu")


def test_estimator_runs_on_the_card_unless_asked_otherwise(bundle_dir):
    models = CostModelBundle.load(bundle_dir).models
    if torch.cuda.is_available():
        assert CostEstimator(models).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CostEstimator(models)
    assert CostEstimator(models, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port (the training and launch packages among them),
    and chip_smoke.py, import without JAX or ``repro``."""
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "src" / "repro_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.serve.estimator" in modules and "repro_torch.kernels._build" in modules
    assert {"repro_torch.training", "repro_torch.training.loop", "repro_torch.launch", "repro_torch.launch.train"} <= set(modules)
