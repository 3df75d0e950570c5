"""The port's featurization and GNN forwards against the JAX package.

Featurization must agree exactly (the port keeps numpy copies of the JAX
package's host modules).  The three GNN forwards of the serving path run on
shared parameters (JAX-initialized, carried across with
``params_from_numpy``) with ``use_pallas`` both ways, at ``rtol=atol=1e-4``:
error accumulates over 4 stages and up to 8 depth levels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core.bucketing as jbucketing
import repro.core.gnn as jgnn
import repro.core.graph as jgraph
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.placement import sample_assignment_matrix as jax_sample
from repro_torch import nn, obs
from repro_torch.core import gnn, graph
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.seg_gather import ops as seg_ops
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.estimator import CostEstimator

TOL = dict(rtol=1e-4, atol=1e-4)


def test_featurization_matches_jax_exactly():
    ours, theirs = WorkloadGenerator(seed=0).corpus(16), JaxGenerator(seed=0).corpus(16)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.query.describe() == b.query.describe()
        assert a.placement.assignment == b.placement.assignment
        assert a.labels.as_dict() == b.labels.as_dict()
        for x, y in zip(graph.build_graph_skeleton(a.query, a.cluster), jgraph.build_graph_skeleton(b.query, b.cluster)):
            np.testing.assert_array_equal(x, y)
        assert graph.query_static(a.query) == jgraph.query_static(b.query)
        assign = sample_assignment_matrix(a.query, a.cluster, 8, np.random.default_rng(i))
        np.testing.assert_array_equal(assign, jax_sample(b.query, b.cluster, 8, np.random.default_rng(i)))
        np.testing.assert_array_equal(
            graph.build_a_place_batch(a.query, a.cluster, assign),
            jgraph.build_a_place_batch(b.query, b.cluster, assign),
        )
    assert [graph.bucket_size(n) for n in range(1, 70)] == [jgraph.bucket_size(n) for n in range(1, 70)]
    g = graph.batch_graphs([graph.build_graph(t.query, t.cluster, t.placement) for t in ours[:5]])
    jg = jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in theirs[:5]])
    for x, y in zip(graph.pad_batch(g, 8), jgraph.pad_batch(jg, 8)):
        np.testing.assert_array_equal(x, y)


def test_nn_layers_match_jax():
    """``repro_torch.nn`` against ``repro.nn`` on shared weights, one member
    and with an explicit member axis (E = 3, the JAX side under vmap)."""
    import repro.nn as jnn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 12, 8)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(4, 12))]
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    mlp = jax.vmap(lambda k: jnn.init_mlp(k, [8, 16, 6]))(keys)
    bank = jax.vmap(lambda k: jnn.init_mlp_bank(k, 5, [8, 16, 6]))(keys)
    bank = jax.tree_util.tree_map(lambda b: b + 0.1, bank)  # nonzero biases
    cases = [
        (jnn.apply_mlp, nn.apply_mlp, mlp, ()),
        (jnn.apply_mlp_bank, nn.apply_mlp_bank, bank, (onehot,)),
        (jnn.apply_mlp_bank_slotted, nn.apply_mlp_bank_slotted, bank, (graph.SLOT_RANGES,)),
    ]
    for jfn, fn, p, extra in cases:
        j_extra = tuple(jnp.asarray(e) if isinstance(e, np.ndarray) else e for e in extra)
        t_extra = tuple(torch.from_numpy(e) if isinstance(e, np.ndarray) else e for e in extra)
        want = np.asarray(jax.vmap(lambda pp: jfn(pp, jnp.asarray(x), *j_extra))(p))
        pt = nn.params_from_numpy(jax.tree_util.tree_map(np.asarray, p))
        got = fn(pt, torch.from_numpy(x).expand(3, *x.shape), *t_extra)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=fn.__name__)
        one = fn(nn.tree_map(lambda t: t[1], pt), torch.from_numpy(x), *t_extra)
        np.testing.assert_allclose(one.numpy(), want[1], rtol=1e-5, atol=1e-5, err_msg=fn.__name__)


def _cfgs(use_pallas, hidden=16):
    return jgnn.GNNConfig(hidden=hidden, use_pallas=use_pallas), gnn.GNNConfig(hidden=hidden, use_pallas=use_pallas)


def _jax_params(seed=0, hidden=16, members=None):
    cfg = jgnn.GNNConfig(hidden=hidden)
    if members is None:
        p = jgnn.init_gnn(jax.random.PRNGKey(seed), cfg)
    else:
        p = jax.vmap(lambda k: jgnn.init_gnn(k, cfg))(jax.random.split(jax.random.PRNGKey(seed), members))
    return jax.tree_util.tree_map(np.asarray, p)


def _as_torch(g):
    return graph.JointGraph(*[torch.from_numpy(np.ascontiguousarray(x)) for x in g])


def _placed_inputs(kind="two_way", n=8, seed=21):
    gen = JaxGenerator(seed=seed)
    q, c = gen.query(kind=kind, name="placed"), gen.cluster(6)
    assign = jax_sample(q, c, n, np.random.default_rng(seed))
    skel = jgraph.build_graph_skeleton(q, c)
    a_place = jgraph.build_a_place_batch(q, c, assign)
    return q, c, skel, a_place, jgraph.query_static(q)


# (use_pallas, JAX lowering): the plain path, and the kernel path through the
# JAX package's jnp oracle and through the Pallas interpreter (the kernel body)
ROUTES = [(False, "ref"), (True, "ref"), (True, "interpret")]


def _route(monkeypatch, use_pallas, lowering):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1" if lowering == "interpret" else "0")
    return _cfgs(use_pallas)


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
def test_apply_gnn_batch_scan_matches_jax(use_pallas, lowering, monkeypatch):
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    traces = JaxGenerator(seed=3).corpus(6)
    g = jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    p = _jax_params()
    fwd = jax.jit(jgnn.apply_gnn_batch, static_argnums=(2,))
    want = np.asarray(fwd(p, jax.tree_util.tree_map(jnp.asarray, g), jcfg))
    got = gnn.apply_gnn_batch(nn.params_from_numpy(p), _as_torch(g), cfg)
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
def test_apply_gnn_placed_matches_jax(use_pallas, lowering, monkeypatch):
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    _, _, skel, a_place, static = _placed_inputs()
    p = _jax_params(1)
    fwd = jax.jit(jgnn.apply_gnn_placed, static_argnums=(3, 4))
    want = np.asarray(fwd(p, jax.tree_util.tree_map(jnp.asarray, skel), jnp.asarray(a_place), static, jcfg))
    got = gnn.apply_gnn_placed(nn.params_from_numpy(p), _as_torch(skel), torch.from_numpy(a_place), static, cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
@pytest.mark.parametrize("chunk", [4, 0])
def test_apply_gnn_placed_stacked_matches_jax(use_pallas, lowering, chunk, monkeypatch):
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    _, _, skel, a_place, static = _placed_inputs(kind="three_way", n=8, seed=5)
    n_hw = int(skel.hw_mask.sum())
    p = _jax_params(2, members=2)
    fwd = jax.jit(jgnn.apply_gnn_placed_stacked, static_argnums=(3, 4, 5, 6))
    want = np.asarray(
        fwd(p, jax.tree_util.tree_map(jnp.asarray, skel), jnp.asarray(a_place), static, jcfg, n_hw, chunk)
    )
    got = gnn.apply_gnn_placed_stacked(
        nn.params_from_numpy(p), _as_torch(skel), torch.from_numpy(a_place), static, cfg, n_hw, chunk
    )
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unported_paths_raise_naming_the_roadmap():
    """What the kernels cannot fuse raises: a 3-layer update bank under
    ``use_pallas`` raises on every plan (scan, and the banded fallback of a
    banding)."""
    traces = WorkloadGenerator(seed=3).corpus(4)
    g = graph.batch_graphs([graph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    deep = gnn.GNNConfig(hidden=16, update_layers=3, use_pallas=True)
    deep_params = init_cost_model(torch.Generator().manual_seed(0), CostModelConfig(gnn=deep, n_ensemble=1))
    with pytest.raises(NotImplementedError, match="exactly two"):
        gnn.apply_gnn_stacked(deep_params, _as_torch(g), deep)
    with pytest.raises(NotImplementedError, match="exactly two"):
        gnn.apply_gnn_stacked(deep_params, _as_torch(g), deep, graph.exact_banding(g))


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


@pytest.mark.parametrize("n_ensemble", [1, 3])
def test_kernel_calls_per_score_do_not_depend_on_members(n_ensemble, monkeypatch):
    """E = 2 and E = 6 stacked members: the same kernel-wrapper calls per
    ``score`` forward, because every wrapper takes the member axis."""
    est = _estimator(n_ensemble)
    q, c, _, _, static = _placed_inputs(kind="two_way", n=2, seed=9)
    assign = sample_assignment_matrix(q, c, 16, np.random.default_rng(0))
    est.score(q, c, assign)  # warm the skeleton cache
    launches = tuple(obs.counters().get(f"{k}.launches", 0) for k in ("banked_mlp_slotted", "mp_update"))
    counts = _count_calls(monkeypatch)
    est.score(q, c, assign)
    levels = sum(1 for level in static.updates if level)
    # stage 0 (op_enc, hw_enc) + stages 1-2 (hw_upd, op_upd); one mp_update per level
    assert counts == {"banked_mlp": 4, "mp_update": levels, "mp_sweep": 0, "gather_sum": 0, "segment_sum": 0}
    assert launches == (0, 0)


@pytest.mark.parametrize("plan", ["scan", "banded", "exact"])
def test_plain_and_kernel_routes_agree_on_every_plan(plan, monkeypatch):
    """The one stage-3 walk on one corpus batch: under ``use_pallas`` the scan's and a query's
    placed (exact) levels go through ``mp_update`` one call a level and a banding's table
    through one ``mp_sweep``; the plain route walks the same levels through ``mp_sweep_ref``.
    The two routes agree to ``TOL``."""
    traces = WorkloadGenerator(seed=3).corpus(8)
    g = graph.batch_graphs([graph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    t = max(traces, key=lambda t: sum(1 for level in graph.query_static(t.query).updates if level))
    static = graph.query_static(t.query)
    skel = graph.build_graph_skeleton(t.query, t.cluster)
    a_place = graph.build_a_place_batch(
        t.query, t.cluster, sample_assignment_matrix(t.query, t.cluster, 8, np.random.default_rng(0))
    )
    params = init_cost_model(torch.Generator().manual_seed(0), CostModelConfig(gnn=gnn.GNNConfig(hidden=16), n_ensemble=2))

    def run(use_pallas):
        cfg = gnn.GNNConfig(hidden=16, use_pallas=use_pallas)
        with torch.no_grad():
            if plan == "exact":
                return gnn.apply_gnn_placed_stacked(
                    params, _as_torch(skel), torch.from_numpy(a_place), static, cfg, int(skel.hw_mask.sum()), 0
                ).numpy()
            band = graph.exact_banding(g) if plan == "banded" else None
            return gnn.apply_gnn_stacked(params, _as_torch(g), cfg, band).numpy()

    plain = run(False)
    counts = _count_calls(monkeypatch)
    kernel = run(True)
    levels = {"scan": gnn.GNNConfig().max_depth, "banded": 0, "exact": sum(1 for level in static.updates if level)}
    assert (counts["mp_update"], counts["mp_sweep"]) == (levels[plan], int(plan == "banded"))
    np.testing.assert_allclose(kernel, plain, **TOL)


def _banded_corpus(seed=7, n=12):
    traces = JaxGenerator(seed=seed).corpus(n)
    g = jgraph.pad_batch(
        jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in traces]),
        jgraph.bucket_size(n),
    )
    return g


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
@pytest.mark.parametrize("flavor", ["batch_banding", "exact_banding"])
def test_apply_gnn_batch_banded_matches_jax(use_pallas, lowering, flavor, monkeypatch):
    """The fused ``sweep`` plan, on the conservative and on the trimmed exact
    banding (the port computes the same banding from its own copy)."""
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    g = _banded_corpus()
    jband = getattr(jbucketing, flavor)(g)
    band = getattr(graph, flavor)(graph.JointGraph(*g))
    assert band == jband and len(band.levels) > 1
    assert (band.rows is not None) == (flavor == "exact_banding")
    p = _jax_params(4)
    fwd = jax.jit(jgnn.apply_gnn_batch, static_argnums=(2, 3))
    want = np.asarray(fwd(p, jax.tree_util.tree_map(jnp.asarray, g), jcfg, jband))
    got = gnn.apply_gnn_batch(nn.params_from_numpy(p), _as_torch(g), cfg, band)
    assert got.shape == want.shape == (g.op_x.shape[0], 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
def test_apply_gnn_stacked_exact_banding_matches_jax(use_pallas, lowering, monkeypatch):
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    g = _banded_corpus(seed=11)
    band = jbucketing.exact_banding(g)
    p = _jax_params(5, members=3)
    fwd = jax.jit(jgnn.apply_gnn_stacked, static_argnums=(2, 3))
    want = np.asarray(fwd(p, jax.tree_util.tree_map(jnp.asarray, g), jcfg, band))
    got = gnn.apply_gnn_stacked(nn.params_from_numpy(p), _as_torch(g), cfg, band)
    assert got.shape == want.shape == (3, g.op_x.shape[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the banded forward answers what the full-depth scan answers
    np.testing.assert_allclose(got.numpy(), gnn.apply_gnn_stacked(nn.params_from_numpy(p), _as_torch(g), cfg).numpy(), **TOL)


def _merged_inputs(seed=13, n=6, kinds=("linear", "two_way", "three_way", "two_way")):
    """S distinct structures on one cluster, n sampled placements each."""
    gen = JaxGenerator(seed=seed)
    c = gen.cluster(5)
    qs = [gen.query(kind=k, name=f"m{i}") for i, k in enumerate(kinds)]
    rng = np.random.default_rng(seed)
    skels = jgraph.batch_graphs([jgraph.build_graph_skeleton(q, c) for q in qs])
    blocks, ids = [], []
    for i, q in enumerate(qs):
        a = jax_sample(q, c, n, rng, max_tries_factor=400)
        blocks.append(jgraph.build_a_place_batch(q, c, a))
        ids.append(np.full(len(a), i, dtype=np.int64))
    band = jbucketing.exact_banding(skels)
    max_parents = int(np.asarray(skels.a_flow).sum(axis=-2).max(initial=1))
    return skels, np.concatenate(ids), np.concatenate(blocks), band, max_parents


@pytest.mark.parametrize("use_pallas,lowering", ROUTES)
def test_apply_gnn_merged_matches_jax(use_pallas, lowering, monkeypatch):
    jcfg, cfg = _route(monkeypatch, use_pallas, lowering)
    skels, skel_id, a_place, band, max_parents = _merged_inputs()
    assert band.rows is not None and max_parents == 2
    p = _jax_params(6, members=2)
    fwd = jax.jit(jgnn.apply_gnn_merged, static_argnums=(4, 5, 6))
    want = np.asarray(
        fwd(p, jax.tree_util.tree_map(jnp.asarray, skels), jnp.asarray(skel_id), jnp.asarray(a_place), jcfg, band, max_parents)
    )
    got = gnn.apply_gnn_merged(
        nn.params_from_numpy(p), _as_torch(skels), torch.from_numpy(skel_id), torch.from_numpy(a_place),
        cfg, band, max_parents,
    )
    assert got.shape == want.shape == (2, len(skel_id))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_validate_merged_parents_raises():
    """A parent bound below the stack's true in-degree raises instead of
    silently dropping parents, in the engine and in the check itself."""
    skels, skel_id, a_place, band, max_parents = _merged_inputs(seed=17)
    params = nn.params_from_numpy(_jax_params(0, members=1))
    with pytest.raises(ValueError, match="in-degree .* > max_parents"):
        gnn.apply_gnn_merged(
            params, _as_torch(skels), torch.from_numpy(skel_id), torch.from_numpy(a_place),
            gnn.GNNConfig(hidden=16), band, max_parents - 1,
        )
    with pytest.raises(ValueError, match="wrong sums"):
        gnn.validate_merged_parents(torch.from_numpy(skels.a_flow), 0)
    gnn.validate_merged_parents(skels.a_flow, max_parents)  # the exact bound passes


def _estimator(n_ensemble, hidden=16):
    """A CPU estimator over two 2-layer ``use_pallas`` metric ensembles."""
    cfg = gnn.GNNConfig(hidden=hidden, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {
        m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg, n_ensemble=n_ensemble)),
            CostModelConfig(metric=m, gnn=cfg, n_ensemble=n_ensemble))
        for m in ("latency_p", "success")
    }
    return CostEstimator(models, device="cpu")


@pytest.mark.parametrize("n_ensemble", [1, 3])
def test_one_sweep_call_per_banded_forward(n_ensemble, monkeypatch):
    """``estimate_many`` (exact banding): one ``mp_sweep`` call and no
    ``mp_update`` call per chunk, for E = 2 and E = 6 stacked members."""
    est = _estimator(n_ensemble)
    traces = WorkloadGenerator(seed=5).corpus(12)
    batches = [traces[:5], traces[5:9], traces[9:]]
    counts = _count_calls(monkeypatch)
    est.estimate_many(batches)
    assert counts == {"banked_mlp": 4, "mp_update": 0, "mp_sweep": 1, "gather_sum": 0, "segment_sum": 0}
    counts.update(dict.fromkeys(counts, 0))
    est.estimate_many(batches, max_rows=8)  # two chunks
    assert counts["mp_sweep"] == 2 and counts["mp_update"] == 0


@pytest.mark.parametrize("n_ensemble", [1, 3])
def test_seg_gather_calls_per_merged_forward(n_ensemble, monkeypatch):
    """``score_many``: one ``segment_sum``, one stage-2 ``gather_sum`` plus
    one per stage-3 level, no ``mp_update`` / ``mp_sweep``, whatever E."""
    est = _estimator(n_ensemble)
    gen = WorkloadGenerator(seed=9)
    reqs = []
    for i, k in enumerate(("linear", "two_way", "three_way")):
        q, c = gen.query(kind=k, name=f"c{i}"), gen.cluster(4)
        reqs.append((q, c, sample_assignment_matrix(q, c, 5, np.random.default_rng(i))))
    est.score_many(reqs)  # warm the merged group
    (group,) = est._merged_groups.values()
    band = group.banding
    counts = _count_calls(monkeypatch)
    est.score_many(reqs)
    levels = len(band.levels)
    # stage 0 (op_enc, hw_enc), stages 1-2 (hw_upd, op_upd), one op_upd per level
    assert counts == {"banked_mlp": 4 + levels, "mp_update": 0, "mp_sweep": 0, "gather_sum": 1 + levels, "segment_sum": 1}


@pytest.mark.parametrize("hidden", [12, 100, 128])
def test_apply_gnn_stacked_widths_match_jax(hidden, monkeypatch):
    """Hidden widths across the JAX kernels' envelope (F <= 2H, H <= 128): a
    width that is no multiple of 8 and the largest one.  The port's banded
    forward of 3 members with ``use_pallas=True`` (on the CPU the wrappers run
    their plain versions; on a card the kernels run zero-padded ragged
    widths, ``test_torch_cuda.py::test_cost_model_widths_through_kernels_match_plain``)
    against JAX's ``use_pallas=True`` forward through the Pallas interpreter."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    jcfg, cfg = _cfgs(True, hidden)
    g = _banded_corpus(seed=11)
    band = jbucketing.exact_banding(g)
    p = _jax_params(7, hidden=hidden, members=3)
    fwd = jax.jit(jgnn.apply_gnn_stacked, static_argnums=(2, 3))
    want = np.asarray(fwd(p, jax.tree_util.tree_map(jnp.asarray, g), jcfg, band))
    got = gnn.apply_gnn_stacked(nn.params_from_numpy(p), _as_torch(g), cfg, graph.exact_banding(graph.JointGraph(*g)))
    assert got.shape == want.shape == (3, g.op_x.shape[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
