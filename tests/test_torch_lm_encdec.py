"""The whisper encoder-decoder and the InternVL2 vision prefix against the JAX package.

``_sinusoidal``, ``cross_kv``, cross-attention uncached and cached,
``run_encoder`` on the naive path (16 frames) and the blocked one (1,100
frames, past ``ATTN_BLOCK``), the uncached ``forward`` with ``frames`` and
with ``vis_embeds``, the decode cache with its cross-attention keys and
values filled by ``run_encoder`` and ``cross_kv`` in each package then a
``serve_step`` prefill and 6 decode steps, a vision prompt prefilled through
``forward`` into the cache then decoded, ``make_prefill_step`` and
``lm_loss`` with each frontend, and the full configs' trees on the meta
device.  Reduced configs, float32, JAX-made weights carried across with
``nn.params_from_numpy``; ``TOL`` (1e-5) unless a test states otherwise.

``_sinusoidal`` is held within ``2**-23 x`` its largest position (plus
``TOL``): XLA's exp on the CPU is not correctly rounded (27 of whisper's 256
frequencies lie one ulp from the float64 value rounded, against torch's 2),
and an angle of 1,500 rad moves by 1,500 times that ulp.  The tests past a
thousand frames therefore feed JAX's table to the port (``same_sinusoid``),
so that the rest of the model is held at ``TOL``.

Three behaviours of the JAX package are held as they are: the blocked
attention keeps zero-padded keys in the softmax when no causal or length
mask drops them (1,500 keys: 548 padded ones); the cross-attention cache
has 1,500 rows, attended with no length mask, so fewer frames leave zero
rows in the softmax; and encoder and decoder add sinusoidal positions and
apply RoPE in self-attention as well.
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

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol=TOL):
    """Every leaf of the port's tree against the same path of the JAX tree."""
    nn.tree_map(lambda t, a: np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **tol), got, _np(want))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reduced(arch):
    jcfg, cfg = jconfigs.reduced(jconfigs.get_config(arch)), configs.reduced(configs.get_config(arch))
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    jp = jparams.materialize(jax.random.PRNGKey(0), jtf.model_defs(jcfg), dtype_override=jnp.float32)
    return jcfg, cfg, jp, nn.params_from_numpy(_np(jp))


def _tokens(n, length, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, length)).astype(np.int32)


@pytest.fixture
def same_sinusoid(monkeypatch):
    """The port's ``_sinusoidal`` replaced by JAX's table (see the module docstring)."""
    def jax_table(positions, d):
        return torch.tensor(np.asarray(jtf._sinusoidal(jnp.asarray(positions.cpu().numpy()), d)))

    monkeypatch.setattr(transformer, "_sinusoidal", jax_table)


def _cross_cfgs():
    c = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    jc = dataclasses.replace(jblocks.AttnConfig(**c), cross=True, causal=False)
    return jc, dataclasses.replace(blocks.AttnConfig(**c), cross=True, causal=False)


# -- pieces -------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("start", [0, 1437])
def test_sinusoidal_matches_jax(start, d):
    pos = np.arange(start, start + 63, dtype=np.int32)
    got = transformer._sinusoidal(_torch(pos), d)
    assert got.dtype == torch.float32 and got.shape == (63, d)
    want = np.asarray(jtf._sinusoidal(jnp.asarray(pos), d))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"], atol=TOL["atol"] + 2.0**-23 * pos.max())
    if start == 0:  # angles below 63 rad: within TOL
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cross_kv_matches_jax():
    jc, tc = _cross_cfgs()
    jp = jparams.materialize(jax.random.PRNGKey(1), jblocks.attn_defs(jc), dtype_override=jnp.float32)
    enc = _x((2, 30, 32), 2)
    got = blocks.cross_kv(nn.params_from_numpy(_np(jp)), _torch(enc), tc)
    assert got["k"].shape == (2, 30, 2, 8)
    _close(got, jblocks.cross_kv(jp, enc, jc))


@pytest.mark.parametrize("keys", [20, 1100])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_jax(cached, keys):
    """Uncached: keys and values from ``kv_source``.  Cached: read from a
    cache that ``cross_kv`` filled, returned unchanged.  1,100 keys take the
    blocked path (padded to 2,048, the padded keys kept)."""
    jc, tc = _cross_cfgs()
    jp = jparams.materialize(jax.random.PRNGKey(3), jblocks.attn_defs(jc), dtype_override=jnp.float32)
    tp = nn.params_from_numpy(_np(jp))
    x, enc, pos = _x((2, 5, 32), 4), _x((2, keys, 32), 5), np.arange(7, 12, dtype=np.int32)
    if not cached:
        jy, jcache = jblocks.apply_attn(jp, x, jc, positions=pos, kv_source=enc)
        ty, tcache = blocks.apply_attn(tp, _torch(x), tc, positions=_torch(pos), kv_source=_torch(enc))
        assert jcache is None and tcache is None
    else:
        jkv = jblocks.cross_kv(jp, enc, jc)
        tkv = blocks.cross_kv(tp, _torch(enc), tc)
        jy, jcache = jblocks.apply_attn(jp, x, jc, positions=pos, cache=jkv)
        ty, tcache = blocks.apply_attn(tp, _torch(x), tc, positions=_torch(pos), cache=tkv)
        assert tcache is tkv
        _close(tcache, jcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    with pytest.raises(ValueError, match="kv_source"):
        blocks.apply_attn(tp, _torch(x), tc, positions=_torch(pos))


def test_blocked_attention_keeps_the_padded_keys_like_jax():
    """Reference behaviour: 1,500 non-causal keys with no length mask are
    padded to 2,048 and the 548 zero keys stay in the softmax, in both
    packages alike, so the blocked path departs from the naive one there;
    a length mask of 1,500 drops them and the paths meet."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, 4, 2, 16), (1, 1500, 2, 16), (1, 1500, 2, 16)))
    qp, kp = np.arange(4, dtype=np.int32), np.arange(1500, dtype=np.int32)
    kw = dict(causal=False, window=None, cap=None)
    tq, tk, tv, tqp, tkp = (_torch(a) for a in (q, k, v, qp, kp))
    got = blocks._attend_blocked(tq, tk, tv, q_pos=tqp, k_pos=tkp, **kw)
    want = jblocks._attend_blocked(q, k, v, q_pos=qp, k_pos=kp, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    naive = blocks._attend_naive(tq, tk, tv, q_pos=tqp, k_pos=tkp, **kw)
    jnaive = jblocks._attend_naive(q, k, v, q_pos=qp, k_pos=kp, **kw)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive), **TOL)
    assert float((got - naive).abs().max()) > 1e-3 and float(np.abs(np.asarray(want - jnaive)).max()) > 1e-3
    masked = blocks._attend_blocked(tq, tk, tv, q_pos=tqp, k_pos=tkp, k_len=1500, **kw)
    torch.testing.assert_close(masked, naive, **TOL)


# -- the whisper encoder and decoder --------------------------------------------------


@pytest.mark.parametrize("frames", [16, 1100])
def test_run_encoder_matches_jax(frames, request):
    """The encoder's groups over sinusoidal-positioned frames: 16 frames on
    the naive attention path, 1,100 on the blocked one (with JAX's table)."""
    if frames > 1000:
        request.getfixturevalue("same_sinusoid")
    jcfg, cfg, jp, tp = _reduced("whisper-base")
    fr = _x((2, frames, 64), 6)
    want = jtf.run_encoder(jp, jcfg, jnp.asarray(fr))
    with torch.no_grad():
        got = transformer.run_encoder(tp, cfg, _torch(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("frames", [16, 1100])
def test_forward_with_frames_matches_jax(frames, request):
    if frames > 1000:
        request.getfixturevalue("same_sinusoid")
    jcfg, cfg, jp, tp = _reduced("whisper-base")
    toks, fr = _tokens(2, 12), _x((2, frames, 64), 7)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), frames=jnp.asarray(fr))
    with torch.no_grad():
        got, cache = transformer.forward(tp, cfg, _torch(toks), frames=_torch(fr))
    assert cache is None and got.shape == (2, 12, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="needs frames"):
        transformer.forward(tp, cfg, _torch(toks))


def _fill_cross(jcfg, cfg, jp, tp, jcache, tcache, frames):
    """Each package's decode cache with ``xk`` / ``xv`` from its own
    ``run_encoder`` and ``cross_kv``: one ``cross_kv`` per ``dec`` layer,
    stacked along the layers axis, written into the first rows."""
    T = frames.shape[1]
    enc = jtf.run_encoder(jp, jcfg, jnp.asarray(frames))
    kvs = [jblocks.cross_kv(jax.tree_util.tree_map(lambda a: a[i], jp["groups"]["b0"]["cross"]), enc,
                            jcfg.cross_cfg()) for i in range(jcfg.n_groups)]
    with torch.no_grad():
        tenc = transformer.run_encoder(tp, cfg, _torch(frames))
        tkvs = [blocks.cross_kv(nn.tree_map(lambda t: t[i], tp["groups"]["b0"]["cross"]), tenc, cfg.cross_cfg())
                for i in range(cfg.n_groups)]
    for key, name in (("xk", "k"), ("xv", "v")):
        jc = jcache["groups"]["b0"]
        jc[key] = jc[key].at[:, :, :T].set(jnp.stack([kv[name] for kv in kvs]).astype(jc[key].dtype))
        tcache["groups"]["b0"][key][:, :, :T] = torch.stack([kv[name] for kv in tkvs])
    return jcache, tcache


@pytest.mark.parametrize("frames", [1500, 16])
def test_serve_step_from_a_cross_kv_cache_matches_jax(frames, request):
    """A 12-token ``serve_step`` prefill into a 24-position cache whose
    ``xk`` / ``xv`` (1,500 rows) hold the encoded frames, then 6 decode steps
    teacher-forced from JAX's greedy tokens; logits, next tokens and every
    cache leaf after each step.  1,500 frames fill the rows; 16 leave 1,484
    zero rows that both packages attend, so the cached decoder departs from
    the uncached forward over the same 16 frames.  (1,500 frames: JAX's
    sinusoid table.)"""
    if frames > 1000:
        request.getfixturevalue("same_sinusoid")
    jcfg, cfg, jp, tp = _reduced("whisper-base")
    jcache = jparams.materialize(jax.random.PRNGKey(1), jtf.model_cache_defs(jcfg, 2, 24), dtype_override=jnp.float32)
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 24), torch.float32, "cpu")
    assert tcache["groups"]["b0"]["xk"].shape == (2, 2, transformer.ENC_LEN, 2, 16)
    fr = _x((2, frames, 64), 8)
    jcache, tcache = _fill_cross(jcfg, cfg, jp, tp, jcache, tcache, fr)
    _close(tcache, jcache)
    jstep, tstep = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg, device="cpu")
    toks, pos, fed = _tokens(2, 12), 0, [_tokens(2, 12)]
    for step in range(7):
        jl, jcache, jnext = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos, jnp.int32))
        tl, tcache, tnext = tstep(tp, tcache, toks, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        _close(tcache, jcache)
        assert tnext.dtype == torch.int32 and np.array_equal(tnext.numpy(), np.asarray(jnext))
        pos += toks.shape[1]
        toks = np.asarray(jnext)
        fed.append(toks)
    with torch.no_grad():
        uncached, _ = transformer.forward(tp, cfg, _torch(np.concatenate(fed[:-1], 1)), frames=_torch(fr))
    gap = float((uncached[:, -1] - tl[:, 0]).abs().max())
    assert gap < 1e-4 if frames == 1500 else gap > 1e-3


def test_frames_given_to_a_cached_forward_are_not_read():
    """A cached forward encodes frames it is given, then reads the cache, in
    both packages: the logits equal those without frames."""
    jcfg, cfg, jp, tp = _reduced("whisper-base")
    jcache = jparams.materialize(jax.random.PRNGKey(1), jtf.model_cache_defs(jcfg, 2, 16), dtype_override=jnp.float32)
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 16), torch.float32, "cpu")
    jcache, tcache = _fill_cross(jcfg, cfg, jp, tp, jcache, tcache, _x((2, 20, 64), 9))
    toks, other = _tokens(2, 8), _x((2, 20, 64), 10)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), frames=jnp.asarray(other), cache=jcache,
                        cache_len=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        with_frames, _ = transformer.forward(tp, cfg, _torch(toks), frames=_torch(other), cache=tcache, cache_len=0)
        without, _ = transformer.forward(tp, cfg, _torch(toks), cache=tcache, cache_len=0)
    assert torch.equal(with_frames, without)
    np.testing.assert_allclose(with_frames.numpy(), np.asarray(jl), **TOL)


# -- the vision prefix ----------------------------------------------------------------


def test_forward_with_vis_embeds_matches_jax():
    """The 8 patch embeddings go before the 12 tokens: 20 positions."""
    jcfg, cfg, jp, tp = _reduced("internvl2-1b")
    toks, vis = _tokens(2, 12), _x((2, 8, 64), 11)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), vis_embeds=jnp.asarray(vis))
    with torch.no_grad():
        got, _ = transformer.forward(tp, cfg, _torch(toks), vis_embeds=_torch(vis))
        bf16_prefix, _ = transformer.forward(tp, cfg, _torch(toks), vis_embeds=_torch(vis).bfloat16())
    assert got.shape == (2, 20, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the prefix is cast to the embeddings' dtype (float32 here)
    torch.testing.assert_close(bf16_prefix, transformer.forward(tp, cfg, _torch(toks),
                                                                vis_embeds=_torch(vis).bfloat16().float())[0])


def test_vlm_prefill_into_the_cache_then_decode_matches_jax():
    """A vision prompt (8 patch embeddings + 12 tokens) prefilled through
    ``forward`` into a 32-position cache, as the JAX package does (its
    serving step takes tokens only), then 6 ``serve_step`` decode steps."""
    jcfg, cfg, jp, tp = _reduced("internvl2-1b")
    jcache = jparams.materialize(jax.random.PRNGKey(1), jtf.model_cache_defs(jcfg, 2, 32), dtype_override=jnp.float32)
    tcache = params.materialize(None, transformer.model_cache_defs(cfg, 2, 32), torch.float32, "cpu")
    toks, vis = _tokens(2, 12, seed=2), _x((2, 8, 64), 12)
    jl, jcache = jtf.forward(jp, jcfg, jnp.asarray(toks), vis_embeds=jnp.asarray(vis), cache=jcache,
                             cache_len=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        tl, tcache = transformer.forward(tp, cfg, _torch(toks), vis_embeds=_torch(vis), cache=tcache, cache_len=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close(tcache, jcache)
    jstep, tstep = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg, device="cpu")
    nxt, pos = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None], 20
    for step in range(6):
        jl, jcache, jnext = jstep(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        tl, tcache, tnext = tstep(tp, tcache, nxt, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {step}")
        _close(tcache, jcache)
        assert np.array_equal(tnext.numpy(), np.asarray(jnext))
        nxt, pos = np.asarray(jnext), pos + 1


# -- the steps with each frontend ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-base"])
def test_prefill_step_and_lm_loss_with_a_frontend_match_jax(arch):
    """``make_prefill_step`` passes the frontend input through; ``lm_loss``
    drops the vision prefix's logits before the shifted cross entropy."""
    jcfg, cfg, jp, tp = _reduced(arch)
    batch = {"tokens": _tokens(3, 10, seed=1)}
    batch["vis_embeds" if arch == "internvl2-1b" else "frames"] = _x((3, 8 if arch == "internvl2-1b" else 24, 64), 13)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    want = jsteps.make_prefill_step(jcfg)(jp, jbatch)
    got = steps.make_prefill_step(cfg, device="cpu")(tp, batch)
    assert got.shape == (3, 1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_loss = jax.jit(lambda p, b: jsteps.lm_loss(p, jcfg, b))(jp, jbatch)
    with torch.no_grad():
        loss = steps.lm_loss(tp, cfg, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


# -- the full configs, without allocating ----------------------------------------------------


def _def_tree(tree):
    def leaf(d):
        dtype = str(d.dtype)[6:] if isinstance(d.dtype, torch.dtype) else np.dtype(d.dtype).name
        return (d.shape, d.axes, d.init, d.scale, dtype, d.granularity)

    return jax.tree_util.tree_map(leaf, tree, is_leaf=lambda x: hasattr(x, "axes"))


@pytest.mark.parametrize("arch,count", [("internvl2-1b", 629_636_224), ("whisper-base", 70_642_176)])
def test_full_config_trees_match_jax(arch, count):
    """The published configs: parameter and cache trees (whisper's
    ``enc_groups``, ``enc_norm``, the decoder's ``norm_c`` / ``cross`` and
    its ``xk`` / ``xv`` cache at 1,500 rows), counts and bytes, and the
    materialized leaves on the meta device."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    defs, jdefs = transformer.model_defs(cfg), jtf.model_defs(jcfg)
    assert _def_tree(defs) == _def_tree(jdefs)
    assert params.count_params(defs) == jparams.count_params(jdefs) == count
    assert params.bytes_params(defs) == jparams.bytes_params(jdefs)
    cache = transformer.model_cache_defs(cfg, 2, 448)
    assert _def_tree(cache) == _def_tree(jtf.model_cache_defs(jcfg, 2, 448))
    made = params.materialize(torch.Generator(), defs, device="meta")
    shapes = jax.eval_shape(lambda k: jparams.materialize(k, jdefs), jax.random.PRNGKey(0))
    nn.tree_map(lambda t, s: (t.is_meta and tuple(t.shape) == s.shape and str(t.dtype)[6:] == str(s.dtype))
                or pytest.fail(f"{t.shape} {t.dtype} against {s}"), made, shapes)
    if arch == "whisper-base":
        assert defs["enc_groups"]["b0"]["attn"]["wq"].shape == (6, 512, 512)
        assert cache["groups"]["b0"]["xk"].shape == (6, 2, 1500, 8, 64)
