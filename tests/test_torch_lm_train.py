"""The port's LM training path (RecurrentGemma-2B) against the JAX package.

On the CPU ``linear_scan`` runs its plain version under autograd; these tests
hold ``linear_scan_bwd`` (the reversed-scan backward that the CUDA path's
``autograd.Function`` runs, here with the plain scan) against autograd of the
plain scan and against ``jax.vjp`` of JAX's ``linear_scan`` (the Pallas
interpreter's forward with its oracle VJP, and the oracle itself) within
``1e-5``; the Function itself is driven here with its launch replaced by the
plain version.  ``cross_entropy`` / ``lm_loss`` and three
``make_train_step`` steps of the reduced ``recurrentgemma-2b`` from JAX-made
float32 weights are held against the JAX package: the loss within ``rtol=1e-4``
(as the forward's logits, ``MODEL_TOL``), a step's loss and grad norm within
``rtol=1e-5`` (means over many terms), parameters within
``rtol=1e-4, atol=1e-5`` (Adam's first steps move each weight by about lr
whatever the gradient's size, so a gradient entry near 0 may flip its
update's sign; the bound holds that to a fraction of lr = 3e-4).  The remat
policies give the same loss and gradients.  ``test_torch_cuda.py`` holds
the Function against the plain VJP on a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import base as jconfigs
from repro.kernels.rglru.ops import linear_scan as jax_linear_scan
from repro.kernels.rglru.ref import linear_scan_ref as jax_linear_scan_ref
from repro.models import params as jparams
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs, nn
from repro_torch.kernels.rglru import ops as scan_ops
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.models import blocks, steps, transformer
from repro_torch.training import optim

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(a):
    return torch.tensor(np.array(a))


def _scan_inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    return a, b, h0, g


# -- the linear_scan backward --------------------------------------------------------


@pytest.mark.parametrize("B,T,D", [(2, 37, 16), (3, 300, 24)])
def test_linear_scan_bwd_matches_autograd_and_jax(B, T, D):
    a, b, h0, g = _scan_inputs(B, T, D, B * 1000 + T)
    ta, tb, th0 = (_torch(x).requires_grad_() for x in (a, b, h0))
    h = linear_scan_ref(ta, tb, th0)
    want = torch.autograd.grad(h, (ta, tb, th0), _torch(g))
    got = scan_ops.linear_scan_bwd(ta.detach(), th0.detach(), h.detach(), _torch(g), linear_scan_ref)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        torch.testing.assert_close(x, y, **TOL)
    for fn in (jax_linear_scan, jax_linear_scan_ref):  # the Pallas interpreter with its oracle VJP; the oracle
        vjp = jax.jit(lambda a, b, h0, g: jax.vjp(fn, a, b, h0)[1](g))
        for x, y in zip(got, vjp(a, b, h0, g)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_linear_scan_bwd_short_and_empty():
    for T in (1, 0):
        a, b, h0, g = _scan_inputs(2, T, 5, T)
        ta, tb, th0 = (_torch(x).requires_grad_() for x in (a, b, h0))
        h = linear_scan_ref(ta, tb, th0)
        got = scan_ops.linear_scan_bwd(ta.detach(), th0.detach(), h.detach(), _torch(g), linear_scan_ref)
        want = (torch.zeros(2, 0, 5), torch.zeros(2, 0, 5), torch.zeros(2, 5)) if T == 0 else \
            torch.autograd.grad(h, (ta, tb, th0), _torch(g))
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, **TOL)


def test_linear_scan_function_runs_the_reversed_scan(monkeypatch):
    """The ``autograd.Function`` of the CUDA path, driven on the CPU with its
    launch replaced by the plain version (run untracked, as a kernel's result
    is): two launches, the forward and the reversed scan; its gradients equal
    ``linear_scan_bwd``'s; an input that does not require grad gets none; a
    launch outside the Function raises."""
    launched = []

    def fake(a, b, h0):
        launched.append(tuple(a.shape))
        with torch.no_grad():
            return linear_scan_ref(a, b, h0)

    monkeypatch.setattr(scan_ops, "_launch", fake)
    a, b, h0, g = _scan_inputs(2, 23, 8, 7)
    ta, tb, th0 = (_torch(x).requires_grad_() for x in (a, b, h0))
    h = scan_ops._LinearScan.apply(ta, tb, th0)
    assert h.grad_fn is not None
    got = torch.autograd.grad(h, (ta, tb, th0), _torch(g))
    assert len(launched) == 2
    want = scan_ops.linear_scan_bwd(ta.detach(), th0.detach(), h.detach(), _torch(g), linear_scan_ref)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    h = scan_ops._LinearScan.apply(ta.detach(), tb, th0.detach())
    (db,) = torch.autograd.grad(h, (tb,), _torch(g))
    assert torch.equal(db, want[1])
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="drop the gradient"):
        scan_ops._launch(ta, tb, th0)


# -- loss ----------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = steps.cross_entropy(_torch(logits), _torch(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _reduced(remat="none"):
    jcfg = jconfigs.reduced(jconfigs.get_config("recurrentgemma-2b"))
    cfg = dataclasses.replace(configs.reduced(configs.get_config("recurrentgemma-2b")), remat=remat)
    jp = jparams.materialize(jax.random.PRNGKey(0), jtf.model_defs(jcfg), dtype_override=jnp.float32)
    return jcfg, cfg, jp, nn.params_from_numpy(_np(jp))


def _tokens(n, length, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(np.int32)


def test_lm_loss_matches_jax():
    jcfg, cfg, jp, tp = _reduced()
    toks = _tokens(2, 12)
    want = jax.jit(lambda p, t: jsteps.lm_loss(p, jcfg, {"tokens": t}))(jp, jnp.asarray(toks))
    got = steps.lm_loss(tp, cfg, {"tokens": toks})
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)
    # a vision prefix before the tokens: its logits are dropped before the loss, in both packages
    vis = np.random.default_rng(1).standard_normal((2, 4, 64)).astype(np.float32)
    want_v = jax.jit(lambda p, t, v: jsteps.lm_loss(p, jcfg, {"tokens": t, "vis_embeds": v}))(
        jp, jnp.asarray(toks), jnp.asarray(vis))
    got_v = steps.lm_loss(tp, cfg, {"tokens": toks, "vis_embeds": vis})
    np.testing.assert_allclose(float(got_v), float(want_v), **MODEL_TOL)
    assert abs(float(got_v) - float(got)) > 1e-4  # the prefix is read


def test_train_steps_match_jax():
    """Three steps of ``make_train_step`` on the reduced model (8 layers,
    window 8, 16 tokens so that attention runs past the window) against the
    JAX package's, from the same float32 weights and the same batch."""
    jcfg, cfg, jp, tp = _reduced()
    tcfg = steps.TrainStepConfig()
    jstep, jopt = jsteps.make_train_step(jcfg, jsteps.TrainStepConfig())
    tstep, topt = steps.make_train_step(cfg, tcfg, device="cpu")
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": topt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    toks = _tokens(2, 16, seed=3)
    jstep = jax.jit(jstep)
    for i in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": toks})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5, err_msg=f"step {i}")
    assert int(tstate["step"]) == 3 and int(tstate["opt"].step) == 3
    assert float(tm["loss"]) < float(steps.lm_loss(tp, cfg, {"tokens": toks}))
    for got, want in ((tstate["params"], jstate["params"]), (tstate["opt"].mu, jstate["opt"].mu)):
        nn.tree_map(lambda t, a: np.testing.assert_allclose(t.numpy(), a, **PARAM_TOL), got, _np(want))


def test_apply_update_equals_the_optimizer_tree_update():
    """The leaf-by-leaf update is ``opt.update`` then ``apply_updates``,
    bitwise, also for bfloat16 parameters (clipped in float32 either way)."""
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(4, 3, generator=gen), "b": [torch.randn(5, generator=gen).bfloat16()]}
    grads = nn.tree_map(lambda p: (10 * torch.randn(p.shape, generator=gen)).to(p.dtype), params)
    tcfg = steps.TrainStepConfig(lr=1e-2)
    opt = steps.make_optimizer(tcfg)
    state = opt.init(params)
    f32 = nn.tree_map(lambda g: g.to(torch.float32), grads)  # what JAX's clip hands Adam
    upd, want_state = opt.update(f32, state, params)
    want = optim.apply_updates(params, upd)
    got, got_state = steps.apply_update(tcfg, grads, state, params, optim.global_norm(grads))
    assert float(optim.global_norm(grads)) > tcfg.max_grad_norm  # the clip is active
    nn.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), (got, got_state), (want, want_state))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_loss_and_grads(remat, monkeypatch):
    """``remat`` changes what the backward keeps, not what it computes: the
    loss and every gradient leaf equal those without remat.  A short
    attention block puts the blocked, checkpointed attention inside each
    rematerialized group."""
    monkeypatch.setattr(blocks, "ATTN_BLOCK", 8)
    _, cfg, _, tp = _reduced()
    toks = _tokens(2, 20, seed=4)
    want_loss, want = steps.lm_loss_and_grads(tp, cfg, {"tokens": toks})
    loss, got = steps.lm_loss_and_grads(tp, dataclasses.replace(cfg, remat=remat), {"tokens": toks})
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    nn.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6), got, want)
    with pytest.raises(ValueError, match="remat"):
        steps.lm_loss_and_grads(tp, dataclasses.replace(cfg, remat="some"), {"tokens": toks})


def test_blocked_attention_gradient_matches_naive(monkeypatch):
    """The blocked attention's gradient (checkpointed under autograd) against
    the naive path's."""
    monkeypatch.setattr(blocks, "ATTN_BLOCK", 16)
    rng = np.random.default_rng(2)
    q, k, v = (_torch(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8)))
    kw = dict(q_pos=torch.arange(40), k_pos=torch.arange(40), causal=True, window=12, cap=None)
    g = _torch(rng.standard_normal((2, 40, 4, 8)).astype(np.float32))
    want = torch.autograd.grad(blocks._attend_naive(q, k, v, **kw), (q, k, v), g)
    got = torch.autograd.grad(blocks._attend(q, k, v, block=16, **kw), (q, k, v), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_train_step_runs_on_the_card_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced(configs.get_config("recurrentgemma-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_train_step(cfg)
    _, _, _, tp = _reduced()
    step, opt = steps.make_train_step(cfg, device="cpu")
    state = {"params": nn.to_device(tp, "meta"), "opt": None, "step": 0}
    with pytest.raises(ValueError, match="move them first"):
        step(state, {"tokens": _tokens(1, 4)})
