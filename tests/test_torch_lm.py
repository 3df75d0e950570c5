"""The port's LM stack (RecurrentGemma-2B serving path) against the JAX package.

On the CPU the ``linear_scan`` wrapper runs its plain version; these tests
hold it, each block, and the reduced ``recurrentgemma-2b`` end to end against
the JAX package on the same numpy inputs and the same weights (JAX
``materialize(..., dtype_override=float32)`` carried across with
``nn.params_from_numpy``).  Tolerances: ``1e-5`` for the kernel's plain
version and each block, ``1e-4`` for the whole model (26 float32 blocks'
rounding, with JAX's associative scan against a sequential loop).
``test_torch_cuda.py`` holds the CUDA kernel against the plain version on a
card.
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
from repro.models import blocks as jblocks
from repro.models import params as jparams
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import nn, obs
from repro_torch import configs
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.models import blocks, params, steps, transformer

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


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


# -- the kernel's plain version ---------------------------------------------------


@pytest.mark.parametrize("B,T,D", [(1, 16, 8), (2, 128, 32), (4, 256, 16), (3, 5, 7), (2, 1, 16)])
def test_linear_scan_plain_matches_jax(B, T, D):
    rng = np.random.default_rng(B * 1000 + T * 10 + D)
    a = rng.uniform(0.5, 0.999, (B, T, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    before = obs.counters().get("linear_scan.launches", 0)
    got = linear_scan(_torch(a), _torch(b), _torch(h0)).numpy()
    assert obs.counters().get("linear_scan.launches", 0) == before  # the CPU runs the plain version, not a kernel
    np.testing.assert_allclose(got, np.asarray(jax_linear_scan(a, b, h0)), **TOL)  # Pallas interpreter
    np.testing.assert_allclose(got, np.asarray(jax_linear_scan_ref(a, b, h0)), **TOL)


def test_linear_scan_empty_and_bad_operands():
    a = torch.rand(2, 0, 5)
    assert linear_scan(a, a, torch.zeros(2, 5)).shape == (2, 0, 5)
    with pytest.raises(TypeError, match="float32"):
        linear_scan(torch.rand(2, 3, 5).double(), torch.rand(2, 3, 5).double(), torch.zeros(2, 5).double())
    with pytest.raises(ValueError, match="h0"):
        linear_scan(torch.rand(2, 3, 5), torch.rand(2, 3, 5), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="one shape"):
        linear_scan(torch.rand(2, 3, 5), torch.rand(2, 4, 5), torch.zeros(2, 5))


def _chunked_scan(a, x, h0, chunk=16):
    """The CUDA kernel's order of operations (``csrc/rglru.cu``) in plain
    torch: chunks of ``chunk`` steps; each chunk's map h -> A h + S from
    zero, the maps folded onto the carry in order for each chunk's carry-in,
    the chunk re-run from there; every product and sum rounded on its own.
    (How the kernel's warps group the chunks into rounds changes nothing; up
    to one chunk, T <= chunk, the re-run from h0 is the plain loop.)"""
    B, T, D = a.shape
    out, carry = torch.empty_like(a), h0.clone()
    for t0 in range(0, T, chunk):
        steps_ = range(t0, min(t0 + chunk, T))
        A, S = torch.ones(B, D), torch.zeros(B, D)
        for t in steps_:
            S, A = a[:, t] * S + x[:, t], A * a[:, t]
        h = carry
        for t in steps_:
            h = a[:, t] * h + x[:, t]
            out[:, t] = h
        carry = A * carry + S
    return out


@pytest.mark.parametrize("T", [2048, 1000])
def test_chunked_scan_order_holds_the_kernel_tolerance(T):
    """The kernel re-associates the recurrence (chunk maps folded into
    carries), so it no longer matches the sequential loop bitwise; at the
    prefill length and at a T that is no multiple of a round, with RG-LRU-like
    inputs (a in (0, 1), half the channels within 1e-5 to 1e-1 of 1, x scaled
    by sqrt(1 - a^2) as ``apply_rglru`` gates it), it stays within ``TOL``."""
    rng = np.random.default_rng(T)
    B, D = 2, 64
    a = rng.uniform(0.0, 1.0, (B, T, D))
    a[..., : D // 2] = 1.0 - 10.0 ** rng.uniform(-5.0, -1.0, (B, T, D // 2))
    x = np.sqrt(1.0 - a**2) * rng.standard_normal((B, T, D))
    a, x = _torch(a.astype(np.float32)), _torch(x.astype(np.float32))
    h0 = _torch(rng.standard_normal((B, D)).astype(np.float32))
    want = linear_scan(a, x, h0)
    got = _chunked_scan(a, x, h0)
    assert not torch.equal(got, want)
    torch.testing.assert_close(got, want, **TOL)


# -- blocks -------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    np.testing.assert_allclose(
        blocks.apply_rmsnorm({"scale": _torch(scale)}, _torch(x), 1e-6).numpy(),
        np.asarray(jblocks.apply_rmsnorm({"scale": scale}, x, 1e-6)), **TOL)
    for pos in (np.arange(5, 12, dtype=np.int32), np.stack([np.arange(7), np.arange(30, 37)]).astype(np.int32)):
        np.testing.assert_allclose(
            blocks.rope(_torch(x), _torch(pos), 10_000.0).numpy(),
            np.asarray(jblocks.rope(x, pos, 10_000.0)), **TOL)
    np.testing.assert_allclose(blocks.softcap(_torch(x), 5.0).numpy(), np.asarray(jblocks.softcap(x, 5.0)), **TOL)


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu"])
def test_ffn_matches_jax(kind):
    jp, tp = _jax_params(jblocks.ffn_defs(32, 48, kind), 1)
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    np.testing.assert_allclose(blocks.apply_ffn(tp, _torch(x), kind).numpy(),
                               np.asarray(jblocks.apply_ffn(jp, x, kind)), **TOL)


def _attn_cfgs(window, **kw):
    c = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, window=window, **kw)
    return jblocks.AttnConfig(**c), blocks.AttnConfig(**c)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("path", ["naive", "blocked"])
@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_attn_matches_jax(mode, path, window):
    """Self-attention uncached, prefilled into a cache, and one decode step
    after a prefill; ``blocked`` has more than ATTN_BLOCK keys, so both
    packages take the online-softmax path."""
    assert blocks.ATTN_BLOCK == jblocks.ATTN_BLOCK == 1024
    jc, tc = _attn_cfgs(window, qk_norm=True)
    jp, tp = _jax_params(jblocks.attn_defs(jc), 2)
    sk = 20 if path == "naive" else 1100  # keys: sequence or cache length
    rng = np.random.default_rng(3)
    if mode == "uncached":
        x = rng.standard_normal((2, sk, 32)).astype(np.float32)
        pos = np.arange(sk, dtype=np.int32)
        jy, _ = jblocks.apply_attn(jp, x, jc, positions=pos)
        ty, _ = blocks.apply_attn(tp, _torch(x), tc, positions=_torch(pos))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        return
    zeros = np.zeros((2, sk, 2, 8), np.float32)
    jcache, tcache = {"k": zeros, "v": zeros}, {"k": _torch(zeros), "v": _torch(zeros)}
    n_prompt = 12 if path == "naive" else sk - 30
    x = rng.standard_normal((2, n_prompt, 32)).astype(np.float32)
    pos = np.arange(n_prompt, dtype=np.int32)
    jy, jcache = jblocks.apply_attn(jp, x, jc, positions=pos, cache=jcache, cache_len=jnp.asarray(0, jnp.int32))
    ty, tcache = blocks.apply_attn(tp, _torch(x), tc, positions=_torch(pos), cache=tcache, cache_len=0)
    if mode == "decode":
        x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
        pos1 = np.asarray([n_prompt], np.int32)
        jy, jcache = jblocks.apply_attn(jp, x1, jc, positions=pos1, cache=jcache,
                                        cache_len=jnp.asarray(n_prompt, jnp.int32))
        ty, tcache = blocks.apply_attn(tp, _torch(x1), tc, positions=_torch(pos1), cache=tcache, cache_len=n_prompt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _close(tcache, jcache, TOL)


def test_attn_cache_overrun_raises():
    """JAX clamps a cache write that would run past the end; the port raises."""
    _, tc = _attn_cfgs(None)
    tp = params.materialize(torch.Generator().manual_seed(0), blocks.attn_defs(tc), torch.float32, "cpu")
    cache = {"k": torch.zeros(1, 8, 2, 8), "v": torch.zeros(1, 8, 2, 8)}
    with pytest.raises(ValueError, match="overruns"):
        blocks.apply_attn(tp, torch.randn(1, 2, 32), tc, positions=torch.arange(7, 9), cache=cache, cache_len=7)


@pytest.mark.parametrize("blockdiag", [False, True])
@pytest.mark.parametrize("jax_kernel", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_rglru_matches_jax(cached, jax_kernel, blockdiag):
    """The RG-LRU block, with JAX's Pallas kernel (interpreter) and its
    associative-scan oracle, against the port's block (plain scan on the CPU)."""
    kw = dict(d_model=32, width=48, n_gate_blocks=4 if blockdiag else 1, block_diag_gates=blockdiag)
    jc, tc = jblocks.RGLRUConfig(use_kernel=jax_kernel, **kw), blocks.RGLRUConfig(use_kernel=True, **kw)
    jp, tp = _jax_params(jblocks.rglru_defs(jc), 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    if not cached:
        jy, _ = jblocks.apply_rglru(jp, x, jc)
        ty, tcache = blocks.apply_rglru(tp, _torch(x), tc)
        assert tcache is None
    else:
        cache = {"h": rng.standard_normal((2, 48)).astype(np.float32),
                 "conv": rng.standard_normal((2, 3, 48)).astype(np.float32)}
        jy, jcache = jblocks.apply_rglru(jp, x, jc, cache=cache)
        ty, tcache = blocks.apply_rglru(tp, _torch(x), tc, cache=nn.params_from_numpy(cache))
        _close(tcache, jcache, TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


# -- the reduced recurrentgemma-2b end to end ------------------------------------------


def _reduced(jax_kernel=False):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("recurrentgemma-2b")), use_rglru_kernel=jax_kernel)
    cfg = configs.reduced(configs.get_config("recurrentgemma-2b"))
    assert cfg.use_rglru_kernel and (cfg.n_layers(), cfg.window) == (jcfg.n_layers(), jcfg.window) == (8, 8)
    jp, tp = _jax_params(jtf.model_defs(jcfg), 0)
    return jcfg, cfg, jp, tp


def _prompts(n, length, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(np.int32)


def test_reduced_forward_matches_jax():
    jcfg, cfg, jp, tp = _reduced()
    toks = _prompts(2, 12)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        tl, cache = transformer.forward(tp, cfg, _torch(toks))
    assert cache is None and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


@pytest.mark.parametrize("jax_kernel", [False, True])
def test_reduced_serve_prefill_then_decode_matches_jax(jax_kernel):
    """``serve_step``: 12 prompt tokens prefilled into a 24-position cache,
    then 6 decode steps past the window of 8, teacher-forced from JAX's
    greedy tokens; logits, next tokens and every cache leaf after each step."""
    jcfg, cfg, jp, tp = _reduced(jax_kernel)
    jcache = jparams.materialize(jax.random.PRNGKey(1), jtf.model_cache_defs(jcfg, 2, 24), dtype_override=jnp.float32)
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 24), torch.float32, "cpu")
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
    assert pos == 18 > cfg.window


def test_reduced_prefill_step_matches_jax():
    jcfg, cfg, jp, tp = _reduced()
    toks = _prompts(3, 10, seed=1)
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg, device="cpu")(tp, {"tokens": toks})
    assert got.shape == (3, 1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    # a model without an encoder reads no frames, in both packages
    frames = np.random.default_rng(2).standard_normal((3, 6, 64)).astype(np.float32)
    want_f = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    got_f = steps.make_prefill_step(cfg, device="cpu")(tp, {"tokens": toks, "frames": frames})
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **MODEL_TOL)
    assert torch.equal(got_f, got)


def test_kernel_and_plain_scan_give_the_same_model():
    """``use_rglru_kernel`` only picks the scan's implementation: on the CPU
    both are the plain loop, so the logits are equal."""
    _, cfg, _, tp = _reduced()
    toks = _torch(_prompts(2, 12))
    with torch.no_grad():
        a, _ = transformer.forward(tp, cfg, toks)
        b, _ = transformer.forward(tp, dataclasses.replace(cfg, use_rglru_kernel=False), toks)
    assert torch.equal(a, b)


# -- parameters, configs, entry points --------------------------------------------------


def _def_tree(tree):
    """A ParamDef tree (either package) as comparable tuples, dtype by name."""
    def leaf(d):
        dtype = str(d.dtype)[6:] if isinstance(d.dtype, torch.dtype) else np.dtype(d.dtype).name
        return (d.shape, d.axes, d.init, d.scale, dtype, d.granularity)

    return jax.tree_util.tree_map(leaf, tree, is_leaf=lambda x: hasattr(x, "axes"))


def test_full_config_defs_match_jax_without_allocating():
    jcfg, cfg = jconfigs.get_config("recurrentgemma-2b"), configs.get_config("recurrentgemma-2b")
    # every field copied; the port runs its kernel by default
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.astuple(dataclasses.replace(cfg, use_rglru_kernel=False)) == dataclasses.astuple(jcfg)
    defs, jdefs = transformer.model_defs(cfg), jtf.model_defs(jcfg)
    assert _def_tree(defs) == _def_tree(jdefs)
    assert params.count_params(defs) == jparams.count_params(jdefs) == 2_894_574_080
    assert params.bytes_params(defs) == jparams.bytes_params(jdefs)
    assert _def_tree(transformer.model_cache_defs(cfg, 8, 4096)) == _def_tree(jtf.model_cache_defs(jcfg, 8, 4096))
    # materialize's leaves have JAX's shapes and dtypes (on the meta device: nothing is allocated)
    made = params.materialize(torch.Generator(), defs, device="meta")
    shapes = jax.eval_shape(lambda k: jparams.materialize(k, jdefs), jax.random.PRNGKey(0))
    nn.tree_map(lambda t, s: (t.is_meta and tuple(t.shape) == s.shape and str(t.dtype)[6:] == str(s.dtype))
                or pytest.fail(f"{t.shape} {t.dtype} against {s}"), made, shapes)


def test_materialize_follows_the_init_rule():
    tree = {"w": params.pdef((400, 300), (None, None), scale=0.5), "v": params.pdef((1000,), (None,)),
            "z": params.pdef((3,), (None,), init="zeros", dtype=torch.float32),
            "o": params.pdef((2, 2), (None, None), init="ones")}
    t = params.materialize(torch.Generator().manual_seed(0), tree, device="cpu")
    assert t["w"].dtype == torch.bfloat16 and t["z"].dtype == torch.float32
    assert abs(float(t["w"].float().std()) - 0.5 / 400 ** 0.5) < 2e-3  # fan_in = shape[-2]
    assert abs(float(t["v"].float().std()) - 1 / 1000 ** 0.5) < 5e-3  # a vector: shape[-1]
    assert not t["z"].any() and bool((t["o"] == 1).all())
    again = params.materialize(torch.Generator().manual_seed(0), tree, dtype_override=torch.float32, device="cpu")
    assert again["w"].dtype == torch.float32 and torch.equal(again["w"].bfloat16(), t["w"])


def test_params_from_numpy_carries_a_bf16_lm_tree():
    """A JAX tree in its declared dtypes (bf16 weights, fp32 norms and lam),
    with stacked groups and the suffix list, crosses key for key."""
    jcfg = jconfigs.reduced(jconfigs.get_config("recurrentgemma-2b"))
    jp = jparams.materialize(jax.random.PRNGKey(3), jtf.model_defs(jcfg))
    tp = nn.params_from_numpy(_np(jp))
    assert isinstance(tp["suffix"], list) and len(tp["suffix"]) == 2
    assert tp["groups"]["b0"]["rec"]["w_x"].shape == (2, 64, 64)
    assert tp["embed"].dtype == torch.bfloat16 and tp["groups"]["b0"]["rec"]["lam"].dtype == torch.float32

    def same(t, a):
        assert str(t.dtype)[6:] == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a).astype(np.float32))

    nn.tree_map(same, tp, _np(jp))


def test_configs_registry_matches_jax():
    assert configs.ARCHS == jconfigs.ARCHS
    assert [dataclasses.astuple(s) for s in configs.SHAPES] == [dataclasses.astuple(s) for s in jconfigs.SHAPES]
    for s in jconfigs.SHAPES:
        assert dataclasses.astuple(configs.get_shape(s.name)) == dataclasses.astuple(s)
        for arch in jconfigs.ARCHS:
            assert configs.cell_supported(arch, configs.get_shape(s.name)) == jconfigs.cell_supported(arch, s)
    for arch in ("whisper-base", "internvl2-1b"):  # the encoder-decoder and the vision frontend
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
        assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    for arch in jconfigs.ARCHS:
        assert configs.get_config(arch).name == jconfigs.get_config(arch).name == arch
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    # the encoder-decoder kinds and the vision frontend in place of RG-LRU groups: JAX's trees
    rg, jrg = configs.get_config("recurrentgemma-2b"), jconfigs.get_config("recurrentgemma-2b")
    for change in (dict(pattern=("enc",)), dict(pattern=("dec",)), dict(frontend="vision")):
        got = transformer.model_defs(dataclasses.replace(rg, **change))
        assert _def_tree(got) == _def_tree(jtf.model_defs(dataclasses.replace(jrg, **change)))


def test_entry_points_run_on_the_card_unless_asked_otherwise():
    cfg = configs.reduced(configs.get_config("recurrentgemma-2b"))
    defs = transformer.model_defs(cfg)
    if torch.cuda.is_available():
        assert steps.make_serve_step(cfg) is not None
    else:
        for call in (lambda: params.materialize(torch.Generator(), defs), lambda: steps.make_serve_step(cfg),
                     lambda: steps.make_prefill_step(cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    tp = params.materialize(torch.Generator().manual_seed(0), defs, device="cpu")
    assert tp["embed"].device.type == "cpu"
    logits = steps.make_prefill_step(cfg, device="cpu")(tp, {"tokens": _prompts(1, 4)})
    assert logits.shape == (1, 1, 512) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="parameters are on"):
        steps.make_prefill_step(cfg, device="meta")(tp, {"tokens": _prompts(1, 4)})
