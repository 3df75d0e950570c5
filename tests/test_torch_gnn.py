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

import repro.core.gnn as jgnn
import repro.core.graph as jgraph
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.placement import sample_assignment_matrix as jax_sample
from repro_torch import nn
from repro_torch.core import gnn, graph
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.mp_update import ops as mp_ops
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
    traces = WorkloadGenerator(seed=3).corpus(4)
    g = graph.batch_graphs([graph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    params = nn.params_from_numpy(_jax_params())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gnn.apply_gnn_batch(params, _as_torch(g), gnn.GNNConfig(hidden=16), graph.batch_banding(g))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gnn.apply_gnn_merged()
    deep = gnn.GNNConfig(hidden=16, update_layers=3, use_pallas=True)
    deep_params = init_cost_model(torch.Generator().manual_seed(0), CostModelConfig(gnn=deep, n_ensemble=1))
    with pytest.raises(NotImplementedError, match="exactly two"):
        gnn.apply_gnn_stacked(deep_params, _as_torch(g), deep)


def _count_calls(monkeypatch):
    """Count wrapper calls (the CPU runs the plain versions: no launches)."""
    counts = {"banked_mlp": 0, "mp_update": 0}

    def counting(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)

        return wrapper

    monkeypatch.setattr(bank_ops, "banked_mlp_slotted", counting("banked_mlp", bank_ops.banked_mlp_slotted))
    monkeypatch.setattr(mp_ops, "mp_update", counting("mp_update", mp_ops.mp_update))
    return counts


@pytest.mark.parametrize("n_ensemble", [1, 3])
def test_kernel_calls_per_score_do_not_depend_on_members(n_ensemble, monkeypatch):
    """E = 2 and E = 6 stacked members: the same kernel-wrapper calls per
    ``score`` forward, because every wrapper takes the member axis."""
    cfg = gnn.GNNConfig(hidden=16, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {
        m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg, n_ensemble=n_ensemble)),
            CostModelConfig(metric=m, gnn=cfg, n_ensemble=n_ensemble))
        for m in ("latency_p", "success")
    }
    est = CostEstimator(models, device="cpu")
    q, c, _, _, static = _placed_inputs(kind="two_way", n=2, seed=9)
    assign = sample_assignment_matrix(q, c, 16, np.random.default_rng(0))
    est.score(q, c, assign)  # warm the skeleton cache
    launches = (bank_ops.banked_mlp_slotted.launches, mp_ops.mp_update.launches)
    counts = _count_calls(monkeypatch)
    est.score(q, c, assign)
    levels = sum(1 for level in static.updates if level)
    # stage 0 (op_enc, hw_enc) + stages 1-2 (hw_upd, op_upd); one mp_update per level
    assert counts == {"banked_mlp": 4, "mp_update": levels}
    assert launches == (0, 0)
