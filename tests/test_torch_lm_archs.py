"""The port's architectures beside RecurrentGemma against the JAX package.

MLA, MoE and the xLSTM blocks, then the nine reduced configs
(``internlm2-1.8b``, ``qwen3-8b``, ``deepseek-67b``, ``gemma2-2b``,
``arctic-480b``, ``deepseek-v2-236b``, ``xlstm-125m``, ``internvl2-1b`` with
its patch-embedding prefix, ``whisper-base`` with its encoder frames and its
decode cache's cross-attention rows filled from them) end to end, held
against the JAX package on the same numpy inputs and the same weights (JAX
``materialize(..., dtype_override=float32)`` carried across with
``nn.params_from_numpy``), and the full configs' ``ParamDef`` trees without
allocating.  Tolerances as ``test_torch_lm.py``: ``1e-5`` for each block,
``1e-4`` for a whole model.  ``test_torch_cuda.py`` holds the MoE and MLA
blocks on a card against the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import base as jconfigs
from repro.models import blocks as jblocks
from repro.models import params as jparams
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs, nn
from repro_torch.models import blocks, params, steps, transformer
from test_torch_lm_encdec import _fill_cross

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("internlm2-1.8b", "qwen3-8b", "deepseek-67b", "gemma2-2b", "arctic-480b", "deepseek-v2-236b", "xlstm-125m",
         "internvl2-1b", "whisper-base")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol):
    """Every leaf of the port's tree against the same path of the JAX tree."""
    nn.tree_map(lambda t, a: np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **tol), got, _np(want))


def _jax_params(tree_defs, seed):
    jp = jparams.materialize(jax.random.PRNGKey(seed), tree_defs, dtype_override=jnp.float32)
    return jp, nn.params_from_numpy(_np(jp))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- MLA ----------------------------------------------------------------------------


def _mla_cfgs():
    c = dict(d_model=32, n_heads=4, q_lora=24, kv_lora=16, d_nope=8, d_rope=4, d_v=6)
    return jblocks.MLAConfig(**c), blocks.MLAConfig(**c)


@pytest.mark.parametrize("path", ["naive", "blocked"])
@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_mla_matches_jax(mode, path):
    """MLA uncached, prefilled into a ``ckv`` cache, and one decode step after
    a prefill; d_v (6) below d_nope + d_rope (12), so ``v`` is padded and the
    output sliced back.  ``blocked`` has more than ATTN_BLOCK keys."""
    jc, tc = _mla_cfgs()
    jp, tp = _jax_params(jblocks.mla_defs(jc), 2)
    sk = 20 if path == "naive" else 1100
    if mode == "uncached":
        x, pos = _x((2, sk, 32), 3), np.arange(sk, dtype=np.int32)
        jy, _ = jblocks.apply_mla(jp, x, jc, positions=pos)
        ty, tcache = blocks.apply_mla(tp, _torch(x), tc, positions=_torch(pos))
        assert tcache is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        return
    zeros = np.zeros((2, sk, 16 + 4), np.float32)
    jcache, tcache = {"ckv": zeros}, {"ckv": _torch(zeros)}
    n_prompt = 12 if path == "naive" else sk - 30
    x, pos = _x((2, n_prompt, 32), 4), np.arange(n_prompt, dtype=np.int32)
    jy, jcache = jblocks.apply_mla(jp, x, jc, positions=pos, cache=jcache, cache_len=jnp.asarray(0, jnp.int32))
    ty, tcache = blocks.apply_mla(tp, _torch(x), tc, positions=_torch(pos), cache=tcache, cache_len=0)
    if mode == "decode":
        x1, pos1 = _x((2, 1, 32), 5), np.asarray([n_prompt], np.int32)
        jy, jcache = jblocks.apply_mla(jp, x1, jc, positions=pos1, cache=jcache,
                                       cache_len=jnp.asarray(n_prompt, jnp.int32))
        ty, tcache = blocks.apply_mla(tp, _torch(x1), tc, positions=_torch(pos1), cache=tcache, cache_len=n_prompt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _close(tcache, jcache, TOL)


def test_mla_cache_overrun_raises():
    """JAX clamps a cache write that would run past the end; the port raises."""
    _, tc = _mla_cfgs()
    tp = params.materialize(torch.Generator().manual_seed(0), blocks.mla_defs(tc), torch.float32, "cpu")
    with pytest.raises(ValueError, match="apply_mla: writing 2 tokens at 7 overruns a cache of 8"):
        blocks.apply_mla(tp, torch.randn(1, 2, 32), tc, positions=torch.arange(7, 9),
                         cache={"ckv": torch.zeros(1, 8, 20)}, cache_len=7)


# -- MoE ----------------------------------------------------------------------------

_MOE = {
    "plain": dict(n_experts=4, top_k=2, expert_ff=24),
    "shared": dict(n_experts=6, top_k=3, expert_ff=16, n_shared=2, shared_ff=20),
    "dense_residual": dict(n_experts=4, top_k=2, expert_ff=24, dense_residual=True, dense_ff=28),
}


@pytest.mark.parametrize("ffn_kind", ["swiglu", "geglu"])
@pytest.mark.parametrize("variant", sorted(_MOE))
def test_moe_matches_jax(variant, ffn_kind):
    """The plain, shared-expert and dense-residual MoE at a prefill (S = 24,
    which may drop pairs) and a decode step (S = 1, which drops none)."""
    jc, tc = jblocks.MoEConfig(**_MOE[variant]), blocks.MoEConfig(**_MOE[variant])
    jp, tp = _jax_params(jblocks.moe_defs(32, jc, ffn_kind), 6)
    for S in (24, 1):
        x = _x((2, S, 32), 7 + S)
        np.testing.assert_allclose(blocks.apply_moe(tp, _torch(x), tc, ffn_kind).numpy(),
                                   np.asarray(jblocks.apply_moe(jp, x, jc, ffn_kind)), **TOL)


def _skewed_moe(case):
    """A 4-expert top-2 MoE whose router sends every token to expert 0, or
    to experts 0 and 1, so that they overflow their capacity of 7 at S = 12:
    ``x[..., 0] = 1`` is a bias feature, ``x[..., 1] = +-1`` alternates with
    the token.  ``alternating``: even tokens prefer expert 0, odd tokens
    expert 1, and each token's other choice is the other expert, so each
    expert takes one pair a token and the pairs of tokens 7..11 are dropped
    whole in JAX's token-major order (slot-major GShard order would drop
    other pairs).  ``first_choice``: expert 0 first for every token, the
    second choice spread over the rest, so tokens 7..11 lose only slot 0."""
    c = dict(n_experts=4, top_k=2, expert_ff=16)
    jc, tc = jblocks.MoEConfig(**c), blocks.MoEConfig(**c)
    jp = jparams.materialize(jax.random.PRNGKey(8), jblocks.moe_defs(16, jc), dtype_override=jnp.float32)
    router = np.array(jp["router"])
    if case == "alternating":
        router[0] = [6.0, 6.0, -6.0, -6.0]
        router[1] = [2.0, -2.0, 0.0, 0.0]
    else:
        router[0] = [6.0, 0.0, 0.0, 0.0]
        router[1] = 0.0
    jp = dict(jp, router=jnp.asarray(router))
    x = _x((2, 12, 16), 9)
    x[..., 0] = 1.0
    x[..., 1] = np.where(np.arange(12) % 2 == 0, 1.0, -1.0)
    return jc, tc, jp, nn.params_from_numpy(_np(jp)), x


@pytest.mark.parametrize("case", ["alternating", "first_choice"])
def test_moe_capacity_overflow_drops_the_pairs_jax_drops(case):
    jc, tc, jp, tp, x = _skewed_moe(case)
    jy = np.asarray(jblocks.apply_moe(jp, x, jc))
    ty = blocks.apply_moe(tp, _torch(x), tc).numpy()
    np.testing.assert_allclose(ty, jy, **TOL)
    # JAX's output really lost pairs: tokens whose output moves when capacity is unbounded
    roomy = np.asarray(jblocks.apply_moe(jp, x, dataclasses.replace(jc, capacity_factor=100.0)))
    jax_lost = np.abs(jy - roomy).max(axis=-1) > 1e-6  # (B, S)
    top_p, top_e, pos, cap = blocks.moe_route(tp, _torch(x), tc)
    assert cap == 7 and set(np.unique(top_e.numpy()[..., 0])) <= {0, 1}
    dropped = (pos >= cap).numpy()  # (B, S, k)
    np.testing.assert_array_equal(dropped.any(-1), jax_lost)
    np.testing.assert_array_equal(jax_lost, np.broadcast_to(np.arange(12) >= 7, (2, 12)))
    if case == "alternating":
        np.testing.assert_array_equal(dropped.all(-1), jax_lost)  # both slots
        assert not np.abs(jy[:, 7:]).any() and (np.abs(jy[:, :7]).max(axis=-1) > 0).all()
    else:
        np.testing.assert_array_equal(dropped[..., 0], jax_lost)  # only the first choice
        assert not dropped[..., 1].any() and (np.abs(jy[:, 7:]).max(axis=-1) > 0).all()
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_route_breaks_ties_like_jax_top_k():
    """Equal router probabilities: the lower expert index first, as ``jax.lax.top_k``."""
    tc = blocks.MoEConfig(n_experts=5, top_k=3, expert_ff=8)
    tp = {"router": torch.zeros(4, 5)}
    _, top_e, pos, cap = blocks.moe_route(tp, torch.randn(1, 3, 4), tc)
    want = np.asarray(jax.lax.top_k(jnp.full((1, 3, 5), 0.2), 3)[1])
    np.testing.assert_array_equal(top_e.numpy(), want)
    np.testing.assert_array_equal(pos.numpy(), [[[0, 0, 0], [1, 1, 1], [2, 2, 2]]])
    assert cap == 3


# -- xLSTM --------------------------------------------------------------------------


def _xlstm_cfgs():
    c = dict(d_model=32, n_heads=4, expansion=2)
    return jblocks.XLSTMConfig(**c), blocks.XLSTMConfig(**c)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_jax(kind, cached):
    """mLSTM and sLSTM uncached (m from -1e30) and from a cache holding a
    state (every leaf carried out)."""
    jc, tc = _xlstm_cfgs()
    jdefs, japply, tapply = ((jblocks.mlstm_defs, jblocks.apply_mlstm, blocks.apply_mlstm) if kind == "mlstm"
                             else (jblocks.slstm_defs, jblocks.apply_slstm, blocks.apply_slstm))
    jp, tp = _jax_params(jdefs(jc), 10)
    x = _x((2, 9, 32), 11)
    if not cached:
        jy, _ = japply(jp, x, jc)
        ty, tcache = tapply(tp, _torch(x), tc)
        assert tcache is None
    else:
        rng = np.random.default_rng(12)
        if kind == "mlstm":  # dh = 2 * 32 / 4
            shapes = {"C": (2, 4, 16, 16), "n": (2, 4, 16), "m": (2, 4)}
        else:
            shapes = dict.fromkeys("cnmh", (2, 32))
        cache = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jy, jcache = japply(jp, x, jc, cache=cache)
        ty, tcache = tapply(tp, _torch(x), tc, cache=nn.params_from_numpy(cache))
        _close(tcache, jcache, TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_xlstm_fresh_cache_starts_the_stabilizer_at_zero():
    """A fresh cache holds m = 0 where the uncached forward starts m at
    -1e30, so in both packages a prefill into the cache departs from the
    uncached forward at the first positions, the forget gates decaying the
    difference; the port departs exactly as JAX does."""
    jcfg, cfg, jp, tp = _reduced("xlstm-125m")
    toks = _prompts(2, 64, seed=3)
    jcache = jparams.materialize(jax.random.PRNGKey(0), jtf.model_cache_defs(jcfg, 2, 64), dtype_override=jnp.float32)
    jcached, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), cache=jcache, cache_len=jnp.asarray(0, jnp.int32))
    juncached, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 64), torch.float32, "cpu")
    with torch.no_grad():
        tcached, _ = transformer.forward(tp, cfg, _torch(toks), cache=tcache, cache_len=0)
        tuncached, _ = transformer.forward(tp, cfg, _torch(toks))
    np.testing.assert_allclose(tcached.numpy(), np.asarray(jcached), **MODEL_TOL)
    np.testing.assert_allclose(tuncached.numpy(), np.asarray(juncached), **MODEL_TOL)
    gap = np.abs(np.asarray(jcached) - np.asarray(juncached)).max(axis=(0, 2))  # by position
    assert gap[0] > 1e-3 and gap[-8:].max() < 1e-5
    np.testing.assert_allclose((tcached - tuncached).abs().amax(dim=(0, 2)).numpy(), gap, rtol=0, atol=1e-4)


# -- the nine reduced configs end to end -----------------------------------------------


def _reduced(arch):
    jcfg, cfg = jconfigs.reduced(jconfigs.get_config(arch)), configs.reduced(configs.get_config(arch))
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    jp, tp = _jax_params(jtf.model_defs(jcfg), 0)
    return jcfg, cfg, jp, tp


def _prompts(n, length, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(np.int32)


def _frontend(cfg, n, seed=5):
    """The config's frontend input as numpy: 8 patch embeddings (vision) or
    16 encoder frames (audio); none for a text-only model."""
    if cfg.frontend == "vision":
        return {"vis_embeds": _x((n, cfg.vis_len, cfg.d_model), seed)}
    if cfg.frontend == "audio":
        return {"frames": _x((n, 16, cfg.d_model), seed)}
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_jax(arch):
    jcfg, cfg, jp, tp = _reduced(arch)
    toks, extra = _prompts(2, 12), _frontend(cfg, 2)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        tl, cache = transformer.forward(tp, cfg, _torch(toks), **{k: _torch(v) for k, v in extra.items()})
    assert cache is None and tl.dtype == torch.float32 and tl.shape[1] == 12 + cfg.vis_len
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serve_prefill_then_decode_matches_jax(arch):
    """``serve_step``: 12 prompt tokens prefilled into a 24-position cache
    (past gemma2's reduced window of 8), then 6 decode steps teacher-forced
    from JAX's greedy tokens; logits, next tokens and every cache leaf after
    each step.  The serving step takes tokens only (a text prompt for
    internvl2); whisper's cache first gets the cross-attention rows of 16
    encoded frames."""
    jcfg, cfg, jp, tp = _reduced(arch)
    jcache = jparams.materialize(jax.random.PRNGKey(1), jtf.model_cache_defs(jcfg, 2, 24), dtype_override=jnp.float32)
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 24), torch.float32, "cpu")
    _close(tcache, jcache, TOL)
    if cfg.enc_pattern:
        _fill_cross(jcfg, cfg, jp, tp, jcache, tcache, _frontend(cfg, 2)["frames"])
        _close(tcache, jcache, TOL)
    jstep, tstep = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg, device="cpu")
    toks, pos = _prompts(2, 12), 0
    for step in range(7):
        jl, jcache, jnext = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos, jnp.int32))
        tl, tcache, tnext = tstep(tp, tcache, toks, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL, err_msg=f"step {step}")
        _close(tcache, jcache, MODEL_TOL)
        assert tnext.dtype == torch.int32 and np.array_equal(tnext.numpy(), np.asarray(jnext))
        pos += toks.shape[1]
        toks = np.asarray(jnext)
    assert pos == 18


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_step_matches_jax(arch):
    jcfg, cfg, jp, tp = _reduced(arch)
    batch = {"tokens": _prompts(3, 10, seed=1), **_frontend(cfg, 3)}
    want = jsteps.make_prefill_step(jcfg)(jp, jax.tree_util.tree_map(jnp.asarray, batch))
    got = steps.make_prefill_step(cfg, device="cpu")(tp, batch)
    assert got.shape == (3, 1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# -- the full configs, without allocating -----------------------------------------------


def _def_tree(tree):
    """A ParamDef tree (either package) as comparable tuples, dtype by name."""
    def leaf(d):
        dtype = str(d.dtype)[6:] if isinstance(d.dtype, torch.dtype) else np.dtype(d.dtype).name
        return (d.shape, d.axes, d.init, d.scale, dtype, d.granularity)

    return jax.tree_util.tree_map(leaf, tree, is_leaf=lambda x: hasattr(x, "axes"))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_defs_match_jax_without_allocating(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    defs, jdefs = transformer.model_defs(cfg), jtf.model_defs(jcfg)
    assert _def_tree(defs) == _def_tree(jdefs)
    assert params.count_params(defs) == jparams.count_params(jdefs)
    assert params.bytes_params(defs) == jparams.bytes_params(jdefs)
    assert _def_tree(transformer.model_cache_defs(cfg, 8, 4096)) == _def_tree(jtf.model_cache_defs(jcfg, 8, 4096))
    # materialize's leaves (some drawn in slices) have JAX's shapes and dtypes, on the meta device
    made = params.materialize(torch.Generator(), defs, device="meta")
    shapes = jax.eval_shape(lambda k: jparams.materialize(k, jdefs), jax.random.PRNGKey(0))
    nn.tree_map(lambda t, s: (t.is_meta and tuple(t.shape) == s.shape and str(t.dtype)[6:] == str(s.dtype))
                or pytest.fail(f"{t.shape} {t.dtype} against {s}"), made, shapes)


def test_materialize_draws_a_large_leaf_in_slices(monkeypatch):
    """A leaf of more than ``DRAW_MAX`` values is drawn in chunks with the
    rule's mean and std; a smaller one draws exactly as one ``randn``.  Every
    RecurrentGemma-2B leaf (the ``lm`` and ``lm_train`` phases' weights) is
    of the second kind, so those draws did not change."""
    rg = transformer.model_defs(configs.get_config("recurrentgemma-2b"))
    assert max(np.prod(d.shape) for _, d in nn.tree_leaves_with_paths(rg)) <= params.DRAW_MAX
    monkeypatch.setattr(params, "DRAW_MAX", 5000)
    tree = {"big": params.pdef((3, 40, 64, 50), (None,) * 4, scale=0.5, dtype=torch.float32),
            "small": params.pdef((64, 50), (None, None), scale=0.5)}
    t = params.materialize(torch.Generator().manual_seed(0), tree, device="cpu")
    big = t["big"]
    assert big.dtype == torch.float32 and big.shape == (3, 40, 64, 50)
    assert abs(float(big.mean())) < 2e-3 and abs(float(big.std()) - 0.5 / 64**0.5) < 1e-3
    # chunks are independent draws, none repeated
    rows = big.reshape(-1, 64 * 50)
    assert torch.unique(rows[:, :4], dim=0).shape[0] == rows.shape[0]
    small = params.materialize(torch.Generator().manual_seed(0), {"small": tree["small"]}, device="cpu")["small"]
    want = (0.5 / 64**0.5 * torch.randn((64, 50), generator=torch.Generator().manual_seed(0))).to(torch.bfloat16)
    assert torch.equal(small, want)
