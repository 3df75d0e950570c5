"""The port's distribution substrate against the JAX package, on gloo CPU groups.

``make_dp_train_step`` at world size 1 against the JAX package's shard_map
step on a ``(1,)`` mesh (the linear model of ``test_distributed.py`` and a
reduced cost model's ``ensemble_loss`` from JAX-made parameters, same Adam,
10 steps, parameters within ``rtol=1e-5, atol=1e-6``); at world sizes 2 and
4, spawned, against world size 1 on the full batch; int8 compression
reaching a tenth of the first loss.  ``pipeline_forward`` on 4 spawned ranks
against the sequential composition, and at one stage against JAX's.  The
sharding rules (``spec_for`` over every ``ParamDef`` of the full
``recurrentgemma-2b``) against JAX's on 512-device mesh shapes given as
mappings, without devices; the elastic helpers; ``reshard_state`` and
``constrain_batch`` on a one-rank CPU ``DeviceMesh``.  Every group
rendezvouses through a ``file://`` store in the test's ``tmp_path`` and is
destroyed by the test.  One card gives world size 1 only (NCCL takes one
rank a GPU), so several ranks are tested here, on the CPU.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import base as jconfigs
from repro.core import gnn as jgnn
from repro.core import model as jmodel
from repro.distributed import make_dp_train_step as jax_dp_step
from repro.distributed import pipeline_forward as jax_pipeline
from repro.dsps import WorkloadGenerator
from repro.models import params as jparams
from repro.models import transformer as jtf
from repro.training import optim as joptim
from repro.training import batching as jbatching
from repro_torch import configs, nn
from repro_torch.core import gnn, graph, model
from repro_torch.distributed import ShardingRules, make_dp_train_step, pipeline_forward, shardings, spec_for
from repro_torch.models import params, sharding_ctx, transformer
from repro_torch.training import batching, elastic, optim

DP_TOL = dict(rtol=1e-5, atol=1e-6)


def _init(store, rank=0, world=1):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)


@pytest.fixture
def group(tmp_path):
    _init(tmp_path / "store")
    yield
    dist.destroy_process_group()


# -- the data-parallel step ----------------------------------------------------------------


def _linear_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _linear_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    w_true = np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return {"x": x, "y": x @ w_true}


def _state(opt, p):
    return {"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32)}


def _run_dp(loss_fn, params, batch, n, compression=None, lr=0.1, group=None):
    opt = optim.adam(lr=lr)
    step = make_dp_train_step(loss_fn, opt, group=group, compression=compression)
    state, losses = _state(opt, params), []
    for i in range(n):
        state, m = step(state, batch, i)
        losses.append(float(m["loss"]))
    return state["params"], losses


def _jax_dp(loss_fn, params, batch, n, lr=0.1):
    opt = joptim.adam(lr=lr)
    state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    step = jax_dp_step(loss_fn, opt, jax.make_mesh((1,), ("data",)))
    for i in range(n):
        state, _ = step(state, batch, jax.random.PRNGKey(i))
    return jax.tree_util.tree_map(np.asarray, state["params"])


def _close(got, want, tol):
    nn.tree_map(lambda t, a: np.testing.assert_allclose(t.numpy(), a, **tol), got, want)


def test_dp_step_world_one_matches_jax_linear(group):
    data = _linear_data()
    want = _jax_dp(lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {"w": jnp.ones((4, 1))},
                   jax.tree_util.tree_map(jnp.asarray, data), 10)
    got, losses = _run_dp(_linear_loss, {"w": torch.ones((4, 1))}, nn.params_from_numpy(data), 10)
    _close(got, want, DP_TOL)
    assert losses[-1] < losses[0]


def test_dp_step_world_one_matches_jax_cost_model(group):
    """A reduced cost model (hidden 16, 2 members) on one exact-banded batch."""
    traces = WorkloadGenerator(seed=14).corpus(24)
    ds, buckets = jbatching.bucket_dataset(jbatching.dataset_from_traces(traces, "latency_p"), exact=True)
    b = max(buckets, key=len)
    sub = ds.select(slice(b.start, b.stop))
    g, y, band = sub.graphs, sub.labels, b.banding
    jcfg = jmodel.CostModelConfig(metric="latency_p", n_ensemble=2, gnn=jgnn.GNNConfig(hidden=16))
    cfg = model.CostModelConfig(metric="latency_p", n_ensemble=2, gnn=gnn.GNNConfig(hidden=16))
    p = jax.tree_util.tree_map(np.asarray, jmodel.init_cost_model(jax.random.PRNGKey(2), jcfg))
    jbatch = (jax.tree_util.tree_map(jnp.asarray, g), jnp.asarray(y))
    want = _jax_dp(lambda pp, bb: jmodel.ensemble_loss(pp, bb[0], bb[1], jcfg, band), p, jbatch, 10, lr=1e-3)
    tg, ty = batching.batch_to_device(g, y, "cpu")
    tband = graph.exact_banding(graph.JointGraph(*g))
    got, losses = _run_dp(lambda pp, bb: model.ensemble_loss(pp, bb[0], bb[1], cfg, tband),
                          nn.params_from_numpy(p), (tg, ty), 10, lr=1e-3)
    _close(got, want, DP_TOL)
    assert losses[-1] < losses[0]


def test_dp_step_int8_converges(group):
    """As the JAX package's test: 60 int8-compressed steps reach a tenth of the first loss."""
    _, losses = _run_dp(_linear_loss, {"w": torch.ones((4, 1))}, nn.params_from_numpy(_linear_data()), 60,
                        compression="int8")
    assert losses[-1] < losses[0] * 0.1


def test_dp_step_needs_a_group():
    step = make_dp_train_step(_linear_loss, optim.adam(lr=0.1))
    with pytest.raises(RuntimeError, match="process group"):
        step(_state(optim.adam(lr=0.1), {"w": torch.ones((4, 1))}), nn.params_from_numpy(_linear_data()), 0)
    with pytest.raises(ValueError, match="compression"):
        make_dp_train_step(_linear_loss, optim.adam(lr=0.1), compression="topk")


def _dp_worker(rank, world, store, out):
    _init(store, rank, world)
    try:
        data = nn.params_from_numpy(_linear_data())
        share = {k: v.chunk(world)[rank] for k, v in data.items()}
        got, losses = _run_dp(_linear_loss, {"w": torch.ones((4, 1))}, share, 10)
        torch.save({"w": got["w"], "losses": losses}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_spawned_ranks_match_one_rank(world, tmp_path):
    """Each rank steps on its share of the batch; every rank ends with the
    parameters one rank gets from the whole batch."""
    _init(tmp_path / "one")
    try:
        want, want_losses = _run_dp(_linear_loss, {"w": torch.ones((4, 1))}, nn.params_from_numpy(_linear_data()), 10)
    finally:
        dist.destroy_process_group()
    mp.spawn(_dp_worker, args=(world, str(tmp_path / "store"), str(tmp_path / "out")), nprocs=world, join=True)
    for rank in range(world):
        got = torch.load(tmp_path / f"out.{rank}")
        np.testing.assert_allclose(got["w"].numpy(), want["w"].numpy(), **DP_TOL)
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)


# -- the pipeline ----------------------------------------------------------------------------


def _stage(w, x):
    return torch.tanh(x @ w)


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    W = torch.tensor(0.5 * rng.standard_normal((4, 8, 8)).astype(np.float32))
    xs = torch.tensor(rng.standard_normal((6, 2, 8)).astype(np.float32))
    return W, xs


def _pipeline_worker(rank, world, store, out):
    _init(store, rank, world)
    try:
        W, xs = _pipeline_inputs()
        torch.save(pipeline_forward(_stage)(W, xs), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_pipeline_four_spawned_stages_match_the_composition(tmp_path):
    """4 stages, 6 microbatches: every rank returns the last stage's outputs,
    equal to the four stages applied in order."""
    mp.spawn(_pipeline_worker, args=(4, str(tmp_path / "store"), str(tmp_path / "out")), nprocs=4, join=True)
    W, xs = _pipeline_inputs()
    want = xs
    for i in range(4):
        want = _stage(W[i], want)
    for rank in range(4):
        torch.testing.assert_close(torch.load(tmp_path / f"out.{rank}"), want, rtol=1e-6, atol=1e-6)


def test_pipeline_one_stage_matches_jax(group):
    rng = np.random.default_rng(1)
    W = rng.standard_normal((1, 8, 8)).astype(np.float32)
    xs = rng.standard_normal((6, 2, 8)).astype(np.float32)
    want = jax_pipeline(lambda w, x: x @ w, jax.make_mesh((1,), ("pipe",)))(jnp.asarray(W), jnp.asarray(xs))
    got = pipeline_forward(lambda p, x: x @ p["w"])({"w": torch.tensor(W)}, torch.tensor(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- sharding rules, elastic ---------------------------------------------------------------


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}])
def test_spec_for_matches_jax_on_the_full_model(mesh):
    """Every ``ParamDef`` of the full recurrentgemma-2b (and its decode cache
    at batch 32), the default rules and one with a replaced entry."""
    jmesh = types.SimpleNamespace(shape=mesh)
    cfg, jcfg = configs.get_config("recurrentgemma-2b"), jconfigs.get_config("recurrentgemma-2b")
    pairs = [(transformer.model_defs(cfg), jtf.model_defs(jcfg)),
             (transformer.model_cache_defs(cfg, 32, 4096), jtf.model_cache_defs(jcfg, 32, 4096))]
    for rules, jrules in ((ShardingRules(), jparams.ShardingRules()),
                          (ShardingRules().replace("act_seq", ("model",)), jparams.ShardingRules().replace("act_seq", ("model",)))):
        assert rules.rules == jrules.rules
        for tree, jtree in pairs:
            got = [spec_for(d, rules, mesh) for d in nn.tree_leaves(tree)]  # the JAX flatten order
            want = [tuple(jparams.spec_for(d, jrules, jmesh)) for d in jax.tree_util.tree_leaves(jtree, is_leaf=jparams.is_def)]
            assert len(got) == len(want) >= 10 and got == want
    assert params.specs(transformer.model_defs(cfg), ShardingRules(), mesh)["embed"] == ("model", "data")


def test_elastic_shapes_and_batch():
    assert elastic.shrink_mesh_shape((2, 16, 16), ("pod", "data", "model"), "data", 2) == (2, 8, 16)
    with pytest.raises(ValueError, match="shrink"):
        elastic.shrink_mesh_shape((2, 16, 16), ("pod", "data", "model"), "data", 3)
    assert elastic.validate_global_batch(64, {"data": 1}) == 64
    assert elastic.validate_global_batch(64, {"pod": 2, "data": 16, "model": 16}) == 2
    with pytest.raises(ValueError, match="divisible"):
        elastic.validate_global_batch(48, {"pod": 2, "data": 16})


def test_reshard_state_and_constrain_on_a_cpu_mesh(group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    assert elastic.validate_global_batch(64, mesh) == 64
    defs = {"w": params.pdef((8, 4), ("embed", "ff")), "lam": params.pdef((4,), ("ff",))}
    sh = shardings(defs, ShardingRules(), mesh)
    assert sh["w"].spec == ("data", "model") and sh["w"].placements == (Shard(0), Shard(1))
    host = {"w": np.arange(32, dtype=np.float32).reshape(8, 4), "lam": np.ones(4, np.float32)}
    placed = elastic.reshard_state(host, sh)
    assert isinstance(placed["w"], DTensor) and placed["w"].placements == (Shard(0), Shard(1))
    np.testing.assert_array_equal(placed["w"].full_tensor().numpy(), host["w"])
    plain = elastic.reshard_state(host, {"w": "cpu", "lam": "cpu"})
    assert torch.equal(plain["lam"], torch.ones(4))
    x = torch.randn(4, 3, 8)
    assert sharding_ctx.constrain_batch(x) is x  # no mesh installed
    with sharding_ctx.use_mesh(mesh):
        assert sharding_ctx.get_mesh() is mesh
        assert sharding_ctx.constrain_batch(x) is x  # a plain tensor is a local shard
        d = sharding_ctx.constrain_batch(DTensor.from_local(x, mesh, [Replicate(), Replicate()]))
        assert d.placements == (Shard(0), Replicate())
        r = sharding_ctx.constrain(d, None, None, "model")
        assert r.placements == (Replicate(), Shard(2)) and torch.equal(r.full_tensor(), x)
    assert sharding_ctx.get_mesh() is None
