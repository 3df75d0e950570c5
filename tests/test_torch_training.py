"""The port's training path against the JAX package, on the CPU.

Each test feeds the same numpy inputs and the same parameters (JAX-made,
carried across with ``params_from_numpy``) to both packages, at a small size
(hidden 16, 2 members, corpora of 12 to 70 traces).  Tolerances: losses,
optimizers and top-k 1e-6 to 1e-7 (the same fp32 formulas); gradients 1e-5;
per-epoch losses of a whole training run ``rtol=1e-4`` and its final params
``atol=1e-4``; bundles ``rtol=1e-4, atol=1e-6`` as the serving tests.  The
JAX kernel ops run under their ``ref`` lowering (the jnp oracle, as the JAX
package's own gradient tests do).  The kernels' ``autograd.Function``
plumbing, which only a CUDA tensor reaches, is driven here with the launch
replaced by the plain version; ``test_torch_cuda.py`` holds the real
launches on a card.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core.metrics as jmetrics
import repro.kernels.banked_mlp.ops as jbank
import repro.kernels.mp_sweep.ops as jsweep
import repro.kernels.mp_update.ops as jupdate
import repro.kernels.seg_gather.ops as jseg
import repro.serve as jserve
import repro.training as jtraining
from repro.core import bucketing as jbucketing
from repro.core import gnn as jgnn
from repro.core import graph as jgraph
from repro.core import model as jmodel
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.training import compression as jcomp
from repro.training import optim as joptim
from repro_torch import nn
from repro_torch.core import gnn, graph, metrics, model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels import common
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.mp_update.ref import mp_update_ref
from repro_torch.kernels.seg_gather import ops as seg_ops
from repro_torch.kernels.seg_gather.ref import gather_sum_ref, segment_sum_ref
from repro_torch.launch import artifacts
from repro_torch.launch import train as launch_train
from repro_torch.serve import bundle as tbundle
from repro_torch.serve.estimator import CostEstimator
from repro_torch.training import batching, checkpoint, compression, loop, optim

H = 16


@pytest.fixture(autouse=True)
def _jax_ref_lowering(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(metric="latency_p", seed=0, members=2, use_pallas=False):
    cfg = jmodel.CostModelConfig(metric=metric, n_ensemble=members, gnn=jgnn.GNNConfig(hidden=H, use_pallas=use_pallas))
    pcfg = model.CostModelConfig(metric=metric, n_ensemble=members, gnn=gnn.GNNConfig(hidden=H, use_pallas=use_pallas))
    return _np_tree(jmodel.init_cost_model(jax.random.PRNGKey(seed), cfg)), cfg, pcfg


def _assert_trees_close(got, want, **tol):
    """A port tree (tensors) against a JAX tree (arrays), leaf by leaf in the
    JAX flatten order, with the same set of paths."""
    got_leaves, want_leaves = nn.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# -- losses, metrics ------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    raw = (3 * rng.normal(size=64)).astype(np.float32)
    y_reg = np.abs(rng.normal(size=64) * 50).astype(np.float32)
    y_cls = (rng.random(64) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(model.msle_loss(_t(raw), _t(y_reg))), float(jmodel.msle_loss(raw, y_reg)), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        float(model.bce_loss(_t(raw), _t(y_cls))), float(jmodel.bce_loss(raw, y_cls)), rtol=1e-6, atol=1e-6
    )
    big = np.array([-90.0, -30.0, 0.0, 30.0, 90.0], np.float32)  # the stable form holds far from 0
    np.testing.assert_allclose(
        float(model.bce_loss(_t(big), _t(np.array([1, 0, 1, 1, 0], np.float32)))),
        float(jmodel.bce_loss(big, np.array([1, 0, 1, 1, 0], np.float32))),
        rtol=1e-6,
    )
    assert model.loss_fn(model.CostModelConfig("backpressure")) is model.bce_loss
    assert model.loss_fn(model.CostModelConfig("throughput")) is model.msle_loss
    traces = WorkloadGenerator(seed=1).corpus(12)
    jtraces = JaxGenerator(seed=1).corpus(12)
    for m in model.ALL_METRICS:
        np.testing.assert_array_equal(model.label_array(traces, m), jmodel.label_array(jtraces, m))


def test_metrics_are_a_pinned_copy():
    rng = np.random.default_rng(3)
    y, p = rng.random(50) * 10, rng.random(50) * 10
    np.testing.assert_array_equal(metrics.qerror(y, p), jmetrics.qerror(y, p))
    assert metrics.qerror_summary(y, p) == jmetrics.qerror_summary(y, p)
    labels = (rng.random(50) > 0.3).astype(np.int64)
    assert metrics.accuracy(labels, labels[::-1]) == jmetrics.accuracy(labels, labels[::-1])
    np.testing.assert_array_equal(
        metrics.balanced_indices(labels, np.random.default_rng(4)),
        jmetrics.balanced_indices(labels, np.random.default_rng(4)),
    )


# -- optimizers -------------------------------------------------------------------------


def _opt_pair(case):
    """(port optimizer, JAX optimizer) of one case."""
    sched = {
        "constant": (optim.constant_schedule(3e-3), joptim.constant_schedule(3e-3)),
        "cosine": (optim.cosine_schedule(1e-2, 5, warmup_steps=2), joptim.cosine_schedule(1e-2, 5, warmup_steps=2)),
    }
    if case == "adam":
        return optim.adam(1e-2), joptim.adam(1e-2)
    if case == "adam_decay_clip":
        s, js = sched["cosine"]
        kw = dict(weight_decay=0.05, max_grad_norm=0.5)
        return optim.adam(s, **kw), joptim.adam(js, **kw)
    if case == "adamw_constant":
        s, js = sched["constant"]
        return optim.adamw(s), joptim.adamw(js)
    if case == "sgd_momentum_cosine":
        s, js = sched["cosine"]
        return optim.sgd(s, momentum=0.9), joptim.sgd(js, momentum=0.9)
    return optim.sgd(0.1), joptim.sgd(0.1)


@pytest.mark.parametrize("case", ["adam", "adam_decay_clip", "adamw_constant", "sgd_momentum_cosine", "sgd"])
def test_optimizers_match_jax(case):
    """Five steps on a random tree (dicts and a list), fed the same grads."""
    rng = np.random.default_rng(7)
    shapes = {"b": {"layers": [{"w": (3, 4), "b": (4,)}, {"w": (4, 2), "b": (2,)}]}, "a": {"w": (5,)}}
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    opt, jopt = _opt_pair(case)
    p, jp = nn.params_from_numpy(params), jax.tree_util.tree_map(jnp.asarray, params)
    st, jst = opt.init(p), jopt.init(jp)
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda x: (2 * rng.normal(size=x.shape)).astype(np.float32), params)
        up, st = opt.update(nn.params_from_numpy(grads), st, p)
        jup, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jst, jp)
        _assert_trees_close(up, jup, rtol=1e-6, atol=1e-6)
        p, jp = optim.apply_updates(p, up), joptim.apply_updates(jp, jup)
    _assert_trees_close(p, jp, rtol=1e-6, atol=1e-6)
    assert int(st.step) == int(jst.step) == 5
    for step in range(8):
        s = torch.tensor(step, dtype=torch.int32)
        for ours, theirs in [(optim.cosine_schedule(1e-2, 6, 2), joptim.cosine_schedule(1e-2, 6, 2)),
                             (optim.constant_schedule(3e-3), joptim.constant_schedule(3e-3))]:
            np.testing.assert_allclose(float(ours(s)), float(theirs(jnp.int32(step))), rtol=1e-6)
    g = nn.params_from_numpy(params)
    np.testing.assert_allclose(float(optim.global_norm(g)), float(joptim.global_norm(params)), rtol=1e-6)


# -- kernel gradients --------------------------------------------------------------------


def _bank(seed, n_types, sizes, members):
    keys = jax.random.split(jax.random.PRNGKey(seed), members)
    return _np_tree(jax.vmap(lambda k: jgnn.nn.init_mlp_bank(k, n_types, sizes))(keys))


def _sweep_case(trim):
    """A banded batch's stage-3 operands, as numpy: (bank, h, a_flow, depth, mask, levels)."""
    traces = JaxGenerator(seed=11).corpus(16)
    g = jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    band = jbucketing.exact_banding(g) if trim else jbucketing.batch_banding(g)
    rows = np.arange(g.op_x.shape[1]) if band.rows is None else np.asarray(band.rows)
    a_flow = np.ascontiguousarray(g.a_flow[:, rows][:, :, rows], dtype=np.float32)
    depth, mask = np.ascontiguousarray(g.op_depth[:, rows]), np.ascontiguousarray(g.op_mask[:, rows], dtype=np.float32)
    levels = jgnn._banded_plan(band, band.ranges or jgraph.SLOT_RANGES).levels
    h = np.random.default_rng(5).normal(size=(2, g.op_x.shape[0], len(rows), H)).astype(np.float32)
    return _bank(3, 5, [2 * H, H, H], 2), h, a_flow, depth, mask, levels


def _flat(p):
    (l1, l2) = p["layers"]
    return l1["w"], l1["b"], l2["w"], l2["b"]


def _kernel_case(name):
    """``(jax_fn, port_fn, function_fn, numpy args)`` for one kernel: the op
    in each package (the port's through its wrapper, which on the CPU runs
    the plain version) and the port's ``autograd.Function`` applied
    directly, as a CUDA tensor reaches it.  Each takes the differentiable
    arguments."""
    rng = np.random.default_rng(17)
    if name == "banked_mlp":
        p = _bank(1, 5, [39, H, H], 2)
        x = rng.normal(size=(2, 6, 12, 39)).astype(np.float32)
        return (
            lambda p, x: jax.vmap(lambda pp, xx: jbank.banked_mlp_slotted(pp, xx, jgraph.SLOT_RANGES))(p, x),
            lambda p, x: bank_ops.banked_mlp_slotted(p, x, graph.SLOT_RANGES),
            lambda p, x: bank_ops._BankedMLP.apply(x, *_flat(p), graph.SLOT_RANGES),
            (p, x),
        )
    if name in ("mp_update", "mp_update_shared"):
        p = _bank(2, 5, [2 * H, H, H], 2)
        h = rng.normal(size=(2, 6, 12, H)).astype(np.float32)
        traces = JaxGenerator(seed=4).corpus(6)
        g = jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in traces])
        a, depth, mask = g.a_flow.astype(np.float32), g.op_depth, g.op_mask.astype(np.float32)
        if name == "mp_update_shared":  # one skeleton for the whole batch: a_flow (N, N)
            a, depth, mask = a[2], depth[2], mask[2]
        static = (2, graph.SLOT_RANGES, None, None, (0, 12, 12), None)
        return (
            lambda p, h, a: jax.vmap(lambda pp, hh: jupdate.mp_update(pp, hh, a, depth, mask, 2, jgraph.SLOT_RANGES))(p, h),
            lambda p, h, a: mp_ops.mp_update(p, h, a, _t(depth), _t(mask), 2, graph.SLOT_RANGES),
            lambda p, h, a: mp_ops._MPUpdate.apply(h, a, *_flat(p), _t(depth), _t(mask), static),
            (p, h, a),
        )
    if name == "mp_sweep":
        p, h, a, depth, mask, levels = _sweep_case(trim=True)
        checked = tuple((d, *mp_ops.check_level("mp_sweep", s, r, pr, h.shape[2], 5)) for d, s, r, pr in levels)
        return (
            lambda p, h, a: jax.vmap(lambda pp, hh: jsweep.mp_sweep(pp, hh, a, depth, mask, levels))(p, h),
            lambda p, h, a: sweep_ops.mp_sweep(p, h, a, _t(depth), _t(mask), levels),
            lambda p, h, a: sweep_ops._MPSweep.apply(h, a, *_flat(p), _t(depth), _t(mask), (checked, None)),
            (p, h, a),
        )
    if name == "gather_sum":
        h = rng.normal(size=(2, 6, 12, H)).astype(np.float32)
        idx = rng.integers(0, 12, size=(6, 9, 2))
        w = (rng.random((6, 9, 2)) > 0.4).astype(np.float32)
        return (
            lambda h, w: jax.vmap(lambda hh: jseg.gather_sum(hh, idx, w))(h),
            lambda h, w: seg_ops.gather_sum(h, _t(idx), w),
            lambda h, w: seg_ops._GatherSum.apply(h, w, _t(idx)),
            (h, w),
        )
    x = rng.normal(size=(2, 6, 12, H)).astype(np.float32)
    seg = rng.integers(0, 5, size=(6, 12))
    return (
        lambda x: jax.vmap(lambda xx: jseg.segment_sum(xx, seg, 5))(x),
        lambda x: seg_ops.segment_sum(x, _t(seg), 5),
        lambda x: seg_ops._SegmentSum.apply(x, _t(seg), 5),
        (x,),
    )


KERNELS = ["banked_mlp", "mp_update", "mp_update_shared", "mp_sweep", "gather_sum", "segment_sum"]


def _torch_args(args, requires_grad=True):
    return [nn.tree_map(lambda a: _t(a).requires_grad_(requires_grad), a) for a in args]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_grads_match_jax(name):
    """Each kernel wrapper's gradient on the CPU (the plain version under
    plain autograd) against ``jax.grad`` of the JAX op under its ``ref``
    lowering, with respect to every differentiable argument; the loss is
    sum(out ** 2)."""
    jfn, tfn, _, args = _kernel_case(name)
    jloss = lambda *a: jnp.sum(jfn(*a) ** 2)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(*args)
    targs = _torch_args(args)
    out = torch.sum(tfn(*targs) ** 2)
    np.testing.assert_allclose(float(out.detach()), float(jloss(*args)), rtol=1e-5)
    got = torch.autograd.grad(out, [leaf for a in targs for leaf in nn.tree_leaves(a)])
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want_leaves)
    for a, b in zip(got, want_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _launch_with_plain(monkeypatch):
    """Replace each CUDA launch by its plain version, run untracked as a
    kernel's result is, and record the launches."""
    launched = []

    def fake(name, plain):
        def run(*args):
            launched.append(name)
            with torch.no_grad():
                return plain(*args)

        return run

    layers = bank_ops._layers
    monkeypatch.setattr(bank_ops, "_launch", fake(
        "banked_mlp", lambda x, w1, b1, w2, b2, r: banked_mlp_slotted_ref(layers(w1, b1, w2, b2), x, r)))
    monkeypatch.setattr(mp_ops, "_launch", fake(
        "mp_update", lambda h, a, w1, b1, w2, b2, dp, m, d, r, bounds, strides: mp_update_ref(
            layers(w1, b1, w2, b2), h, a, dp, m, d, r, bounds[:2], bounds[2])))
    monkeypatch.setattr(sweep_ops, "_launch", fake(
        "mp_sweep", lambda h, a, w1, b1, w2, b2, dp, m, lv, strides: mp_sweep_ref(layers(w1, b1, w2, b2), h, a, dp, m, lv)))
    monkeypatch.setattr(seg_ops, "_launch_gather", fake("gather_sum", lambda h, w, idx: gather_sum_ref(h, idx, w)))
    monkeypatch.setattr(seg_ops, "_launch_segment", fake("segment_sum", segment_sum_ref))
    return launched


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_function_backward_is_the_plain_vjp(name, monkeypatch):
    """The ``autograd.Function`` each CUDA launch runs in, driven on the CPU
    with the launch replaced by the plain version: its gradients equal
    autograd through the plain version bitwise (the same ops on the same
    inputs), a shared ``a_flow``'s summed over the batch; an input that does
    not require grad gets none; and a launch outside the Function raises."""
    launched = _launch_with_plain(monkeypatch)
    _, tfn, fn, args = _kernel_case(name)
    targs = _torch_args(args)
    leaves = [leaf for a in targs for leaf in nn.tree_leaves(a)]
    want = torch.autograd.grad(torch.sum(tfn(*targs) ** 2), leaves)  # on the CPU: plain autograd
    got = torch.autograd.grad(torch.sum(fn(*targs) ** 2), leaves)
    assert launched == [name.replace("_shared", "")]
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    part = _torch_args(args, requires_grad=False)
    part[-1] = targs[-1]  # only the last argument requires grad
    out = fn(*part)
    assert out.requires_grad
    last = nn.tree_leaves(targs[-1])
    got_last = torch.autograd.grad(torch.sum(out ** 2), last)
    for a, b in zip(got_last, want[len(leaves) - len(last):]):
        assert torch.equal(a, b)
    with torch.no_grad():  # no graph is being built: nothing to drop
        fn(*targs)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        common.check_untracked(name, leaves[0])


# -- the full gradient ------------------------------------------------------------------


def _banded_batch(seed=14, n=24):
    traces = JaxGenerator(seed=seed).corpus(n)
    ds = jtraining.dataset_from_traces(traces, "latency_p")
    ds, buckets = jtraining.bucket_dataset(ds, exact=True)
    b = max(buckets, key=len)
    sub = ds.select(slice(b.start, b.stop))
    return sub.graphs, sub.labels, b.banding


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("metric", ["latency_p", "success"])
def test_ensemble_loss_grad_matches_jax(use_pallas, metric):
    """``ensemble_loss`` and its gradient on one banded batch, shared params."""
    g, y, band = _banded_batch()
    assert len(band.levels) > 1
    if metric == "success":
        y = (y > np.median(y)).astype(np.float32)
    p, jcfg, cfg = _jax_model(metric, seed=2, use_pallas=use_pallas)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    want_loss, want = jax.jit(jax.value_and_grad(lambda pp: jmodel.ensemble_loss(pp, jg, jnp.asarray(y), jcfg, band)))(p)
    tg, ty = batching.batch_to_device(g, y, "cpu")
    loss, grads = loop.loss_and_grads(nn.params_from_numpy(p), tg, ty, cfg, graph.exact_banding(graph.JointGraph(*g)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_trees_close(grads, want, rtol=1e-5, atol=1e-5)
    assert all(float(x.abs().max()) > 0 for x in nn.tree_leaves(grads))


# -- batching, compression -------------------------------------------------------------------


@pytest.mark.parametrize("exact", [False, True])
def test_bucketed_batches_match_jax(exact):
    """The same buckets, bandings and batches (index plan and order) from the
    same seed; the split is the same too."""
    n = 70
    ds = batching.dataset_from_traces(WorkloadGenerator(seed=9).corpus(n), "throughput")
    jds = jtraining.dataset_from_traces(JaxGenerator(seed=9).corpus(n), "throughput")
    for a, b in zip(batching.split_indices(n, seed=7), jtraining.split_indices(n, seed=7)):
        np.testing.assert_array_equal(a, b)
    ds, buckets = batching.bucket_dataset(batching.split_dataset(ds, seed=7)[0], exact=exact)
    jds, jbuckets = jtraining.bucket_dataset(jtraining.split_dataset(jds, seed=7)[0], exact=exact)
    assert [(b.n_ops, b.depth, b.start, b.stop, b.banding) for b in buckets] == [
        (b.n_ops, b.depth, b.start, b.stop, b.banding) for b in jbuckets
    ]
    assert batching.n_batches(buckets, 8) == jtraining.n_batches(jbuckets, 8)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for epoch in range(2):
        ours = list(batching.bucketed_batches(ds, buckets, 8, rng=rng))
        theirs = list(jtraining.bucketed_batches(jds, jbuckets, 8, rng=jrng))
        assert len(ours) == len(theirs) == batching.n_batches(buckets, 8)
        for (g, y, band), (jg, jy, jband) in zip(ours, theirs):
            assert band == jband
            np.testing.assert_array_equal(y, jy)
            for a, b in zip(g, jg):
                np.testing.assert_array_equal(a, b)
    # prefetch with a device: the same batches as tensors, one staging buffer each
    want = list(batching.bucketed_batches(ds, buckets, 8, rng=np.random.default_rng(5)))
    got = list(batching.prefetch(batching.bucketed_batches(ds, buckets, 8, rng=np.random.default_rng(5)), device="cpu"))
    assert len(got) == len(want)
    for (g, y, band), (wg, wy, wband) in zip(got, want):
        assert band == wband and torch.equal(y, _t(wy))
        for a, b in zip(g, wg):
            assert a.dtype == _t(b).dtype and torch.equal(a, _t(b))


def test_prefetch_raises_the_worker_error():
    def broken():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(batching.prefetch(broken()))


def test_topk_and_int8_match_jax():
    rng = np.random.default_rng(11)
    grads = {"a": rng.normal(size=(40, 7)).astype(np.float32), "b": [rng.normal(size=(13,)).astype(np.float32)]}
    ef, jef = compression.ef_init(nn.params_from_numpy(grads)), jcomp.ef_init(grads)
    for _ in range(3):  # error feedback carries the residual between steps
        g = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), grads)
        rec, ef, frac = compression.topk_with_error_feedback(nn.params_from_numpy(g), ef, 0.1)
        jrec, jef, jfrac = jcomp.topk_with_error_feedback(g, jef, 0.1)
        assert frac == jfrac
        _assert_trees_close(rec, jrec, rtol=1e-7, atol=1e-7)
        _assert_trees_close(ef.residual, jef.residual, rtol=1e-7, atol=1e-7)
    x = (5 * rng.normal(size=(9, 31))).astype(np.float32)
    q, s = compression.int8_quantize(_t(x), stochastic=False)
    jq, js = jcomp.int8_quantize(jnp.asarray(x), jax.random.PRNGKey(0), stochastic=False)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(compression.int8_dequantize(q, s).numpy(), np.asarray(jcomp.int8_dequantize(jq, js)))
    # stochastic rounding: each value lands on one of its two neighbours
    y = compression.int8_roundtrip({"x": _t(x)}, torch.Generator().manual_seed(0))["x"]
    assert float((y - _t(x)).abs().max()) <= float(s) * (1 + 1e-6)


# -- the training loop -----------------------------------------------------------------


def _one_structure_corpus(gen_cls, n=40, seed=5):
    """Linear queries of one shape (source, filter, sink): one banding, so
    the JAX reference compiles its step once."""
    gen, out = gen_cls(seed=seed), []
    while len(out) < n:
        t = gen.trace(kind="linear")
        if len(t.query.operators) == 3:
            out.append(t)
    return out


TRAIN = dict(epochs=3, batch_size=8, lr=3e-3)


def _jax_topk_reference(tr, va, cfg, tcfg, params):
    """JAX's ``train_cost_model`` with ``compression="topk"``, built from the
    JAX package's own pieces in the same order: under ``jax.jit`` its
    ``topk_decompress`` takes ``int()`` of a traced shape product, which this
    JAX version refuses, so the top-k runs outside the jitted gradient."""
    tr, buckets = jtraining.bucket_dataset(tr, exact=tcfg.exact_banding)
    total = max(1, jtraining.n_batches(buckets, tcfg.batch_size)) * tcfg.epochs
    opt = joptim.adam(
        lr=joptim.cosine_schedule(tcfg.lr, total, warmup_steps=min(100, total // 10)),
        weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm,
    )
    state, ef = opt.init(params), jcomp.ef_init(params)
    value_grad = jax.jit(jax.value_and_grad(lambda p, g, y, b: jmodel.ensemble_loss(p, g, y, cfg, b)), static_argnums=3)
    update = jax.jit(lambda gr, st, p: opt.update(gr, st, p))
    val = jax.jit(lambda p, g, y, b: jmodel.ensemble_loss(p, g, y, cfg, b) / cfg.n_ensemble, static_argnums=3)
    vg, vy, vb = jax.tree_util.tree_map(jnp.asarray, va.graphs), jnp.asarray(va.labels), jgraph.batch_banding(va.graphs)
    rng, history, best, best_params = np.random.default_rng(tcfg.seed + 1), [], float("inf"), params
    for _ in range(tcfg.epochs):
        losses = []
        for g, y, band in jtraining.bucketed_batches(tr, buckets, tcfg.batch_size, rng=rng, device=True):
            loss, grads = value_grad(params, g, y, band)
            grads, ef, _ = jcomp.topk_with_error_feedback(grads, ef, tcfg.topk_frac)
            updates, state = update(grads, state, params)
            params = joptim.apply_updates(params, updates)
            losses.append(float(loss))
        vl = float(val(params, vg, vy, vb))
        history.append({"train_loss": float(np.mean(losses)), "val_loss": vl})
        if vl < best - 1e-4:
            best, best_params = vl, _np_tree(params)
    return history, best_params


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' training runs from one JAX init, with checkpoints."""
    jt, pt = _one_structure_corpus(JaxGenerator), _one_structure_corpus(WorkloadGenerator)
    jtr, jva, _ = jtraining.split_dataset(jtraining.dataset_from_traces(jt, "latency_p"), seed=7)
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(pt, "latency_p"), seed=7)
    p0, jcfg, cfg = _jax_model(seed=0)
    out = {"cfg": (jcfg, cfg), "p0": p0}
    for comp in (None, "topk"):
        ours_dir, theirs_dir = (str(tmp_path_factory.mktemp(f"ckpt_{comp}_{who}")) for who in ("torch", "jax"))
        ours = loop.train_cost_model(tr, va, cfg, loop.TrainConfig(compression=comp, ckpt_dir=ours_dir, **TRAIN),
                                     init_params=nn.params_from_numpy(p0), device="cpu")
        if comp is None:
            res = jtraining.train_cost_model(jtr, jva, jcfg, jtraining.TrainConfig(ckpt_dir=theirs_dir, **TRAIN),
                                             init_params=p0)
            theirs = (res.history, res.params)
        else:
            theirs = _jax_topk_reference(jtr, jva, jcfg, jtraining.TrainConfig(compression="topk", **TRAIN), p0)
        out[comp] = (ours, theirs, ours_dir, theirs_dir)
    return out


@pytest.mark.parametrize("comp", [None, "topk"])
def test_train_cost_model_matches_jax(trained, comp):
    ours, (history, params), _, _ = trained[comp]
    assert len(ours.history) == len(history) == TRAIN["epochs"]
    for a, b in zip(ours.history, history):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=1e-4)
    assert ours.history[-1]["train_loss"] < ours.history[0]["train_loss"]
    _assert_trees_close(ours.params, params, rtol=0, atol=1e-4)
    assert all(t.device.type == "cpu" for t in nn.tree_leaves(ours.params))


def test_checkpoints_cross_between_packages(trained, tmp_path):
    """The same key set, and ``bundle_from_checkpoint`` of each package reads
    the other's checkpoint."""
    ours, _, ours_dir, theirs_dir = trained[None]
    jcfg, cfg = trained["cfg"]
    step = checkpoint.latest_step(ours_dir)
    assert step == jtraining.latest_step(theirs_dir) == ours.steps
    keys = {}
    for who, d in (("torch", ours_dir), ("jax", theirs_dir)):
        with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
            keys[who] = json.load(f)["keys"]
    assert keys["torch"] == keys["jax"]
    assert {"0/hw_enc/layers/0/w", "1/step", "1/mu/op_upd/layers/1/b", "2/residual/out/layers/0/w"} <= set(keys["torch"])
    theirs_in_ours = tbundle.bundle_from_checkpoint(theirs_dir, cfg)
    ours_in_theirs = jserve.bundle_from_checkpoint(ours_dir, jcfg)
    _assert_trees_close(theirs_in_ours.params("latency_p"), ours_in_theirs.params("latency_p"), rtol=0, atol=1e-4)
    _assert_trees_close(tbundle.bundle_from_checkpoint(ours_dir, cfg).params("latency_p"),
                        ours_in_theirs.params("latency_p"), rtol=0, atol=0)
    # resume: a restored state equals the saved one, and continues from its step
    like = (nn.params_from_numpy(trained["p0"]), None, None)
    opt = loop.make_optimizer(loop.TrainConfig(), 10)
    like = (like[0], opt.init(like[0]), compression.ef_init(like[0]))
    state, got_step, _ = checkpoint.restore_checkpoint(ours_dir, like)
    assert got_step == step and int(state[1].step) == step
    _assert_trees_close(state[0], ours_in_theirs.params("latency_p"), rtol=0, atol=0)


def test_bundles_cross_between_packages(trained, tmp_path):
    """A bundle the port saves loads in the JAX ``CostEstimator`` with equal
    estimates; merged per-metric bundles keep every metric and namespace
    conflicting provenance."""
    ours, _, _, _ = trained[None]
    jcfg, cfg = trained["cfg"]
    p_cls, jcfg_cls, cfg_cls = _jax_model("success", seed=1)
    b1 = tbundle.CostModelBundle({"latency_p": (ours.params, cfg)}, meta={"step": 1, "corpus": "x"})
    b2 = tbundle.CostModelBundle({"success": (nn.params_from_numpy(p_cls), cfg_cls)}, meta={"step": 2, "corpus": "x"})
    merged = tbundle.merge_bundles(b1, b2)
    assert merged.metrics == ("latency_p", "success")
    assert merged.meta == {"corpus": "x", "latency_p/step": 1, "success/step": 2}
    d = str(tmp_path / "bundle")
    merged.save(d)
    theirs = jserve.CostModelBundle.load(d)
    assert theirs.metrics == merged.metrics and theirs.meta == merged.meta
    traces = JaxGenerator(seed=21).corpus(24)
    batch = jgraph.batch_graphs([jgraph.build_graph(t.query, t.cluster, t.placement) for t in traces])
    want = jserve.CostEstimator.from_bundle(theirs).estimate(batch)
    got = CostEstimator.from_bundle(tbundle.CostModelBundle.load(d), device="cpu").estimate(graph.JointGraph(*batch))
    np.testing.assert_allclose(got["latency_p"], want["latency_p"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got["success"], want["success"])
    fp = tbundle.corpus_fingerprint(WorkloadGenerator(seed=21).corpus(24))
    assert fp == jserve.corpus_fingerprint(traces)
    with pytest.raises(ValueError):
        tbundle.CostModelBundle({}).save(str(tmp_path / "empty"))


def test_launch_train_stage_main_exports_a_bundle_both_packages_serve(tmp_path, monkeypatch):
    """``stage_main`` on a 30-trace corpus, one epoch a metric, on the CPU:
    five stored ensembles and the bundle ``main``, which the JAX package
    loads."""
    monkeypatch.setattr(artifacts, "ROOT", str(tmp_path))
    monkeypatch.setattr(launch_train, "MAIN_CORPUS", 30)
    results = launch_train.stage_main(1, device="cpu")
    assert set(results) == set(model.ALL_METRICS)
    assert all(r.steps >= 1 and np.isfinite(r.history[0]["val_loss"]) for r in results.values())
    assert artifacts.bundle_exists("main")
    again = launch_train.stage_main(1, device="cpu")  # resumable: everything is stored already
    assert all(r is None for r in again.values())
    ours = artifacts.load_bundle("main")
    theirs = jserve.CostModelBundle.load(artifacts.path("bundles", "main"))
    assert ours.meta == theirs.meta and ours.meta["corpus_size"] == 30
    assert theirs.config("latency_p").gnn.use_pallas
    params, cfg = artifacts.load_cost_model("main_latency_p")
    _assert_trees_close(params, theirs.params("latency_p"), rtol=0, atol=0)
