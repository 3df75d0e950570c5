"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold that
against the JAX ops, run both through the Pallas interpreter (the kernel
body) and through the JAX package's default ref lowering, on the same
numpy inputs and the same weights.  ``test_torch_cuda.py`` holds the CUDA
kernels against the plain versions on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import nn as jnn
from repro.core.graph import SLOT_RANGES
from repro.kernels.banked_mlp.ops import banked_mlp_slotted as jax_banked_mlp
from repro.kernels.mp_sweep.ops import mp_sweep as jax_mp_sweep
from repro.kernels.mp_update.ops import mp_update as jax_mp_update
from repro.kernels.seg_gather.ops import gather_sum as jax_gather_sum, segment_sum as jax_segment_sum
from repro_torch import nn, obs
from repro_torch.core import gnn
from repro_torch.core.graph import batch_banding, batch_graphs, bucket_size, build_graph, exact_banding, pad_batch
from repro_torch.dsps import WorkloadGenerator
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_sweep import ops as sweep_ops
from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
from repro_torch.kernels.mp_update import ops as mp_ops
from repro_torch.kernels.mp_update.ref import mp_update_ref
from repro_torch.kernels.seg_gather import ops as seg_ops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=["ref", "interpret"])
def lowering(request, monkeypatch):
    """The JAX package's two CPU lowerings: its jnp oracle and the Pallas
    interpreter executing the kernel body."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1" if request.param == "interpret" else "0")
    return request.param


def _bank(seed, n_types, sizes, members=None):
    """A JAX banked-MLP params tree as numpy (optionally member-stacked)."""
    if members is None:
        p = jnn.init_mlp_bank(jax.random.PRNGKey(seed), n_types, sizes)
    else:
        keys = jax.random.split(jax.random.PRNGKey(seed), members)
        p = jax.vmap(lambda k: jnn.init_mlp_bank(k, n_types, sizes))(keys)
    return jax.tree_util.tree_map(np.asarray, p)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(
    "F,H,T,N",
    [(4, 64, 5, 12), (39, 64, 5, 12), (128, 64, 5, 12), (4, 64, 1, 8), (128, 16, 1, 8)],
)
def test_banked_mlp_matches_jax(lowering, F, H, T, N):
    rng = np.random.default_rng(F + T)
    p = _bank(F, T, [F, H, H])
    x = rng.normal(size=(3, N, F)).astype(np.float32)
    ranges = SLOT_RANGES if T == 5 else ((0, 0, N),)
    want = np.asarray(jax_banked_mlp(p, jnp.asarray(x), ranges))
    got = bank_ops.banked_mlp_slotted(nn.members(nn.params_from_numpy(p)), _t(x)[None], ranges)[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_banked_mlp_member_axis_with_shared_input(lowering):
    """E members over one input read at member stride 0 == vmap over members."""
    E, F, H = 3, 39, 32
    p = _bank(7, 5, [F, H, H], members=E)
    x = np.random.default_rng(1).normal(size=(2, 12, F)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda pp: jax_banked_mlp(pp, jnp.asarray(x), SLOT_RANGES))(p))
    xt = _t(x).expand(E, *x.shape)
    assert xt.stride(0) == 0
    got = bank_ops.banked_mlp_slotted(nn.params_from_numpy(p), xt, SLOT_RANGES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(banked_mlp_slotted_ref(nn.params_from_numpy(p), xt, SLOT_RANGES).numpy(), want, **TOL)


def test_banked_mlp_wrapper_refuses_what_the_kernel_does_not_take():
    p = nn.members(nn.params_from_numpy(_bank(0, 5, [8, 16, 16])))
    x = torch.zeros((1, 2, 12, 8))
    with pytest.raises(TypeError, match="float32"):
        bank_ops.banked_mlp_slotted(p, x.double(), SLOT_RANGES)
    with pytest.raises(ValueError, match="tile"):
        bank_ops.banked_mlp_slotted(p, x, SLOT_RANGES[1:])
    with pytest.raises(NotImplementedError, match="two layers"):
        bank_ops.banked_mlp_slotted({"layers": p["layers"] * 2}, x, SLOT_RANGES)
    assert obs.counters().get("banked_mlp_slotted.launches", 0) == 0  # the CPU never launches


def _mp_inputs(seed, B, H, shared=False):
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)
    h = rng.normal(size=(B, 12, H)).astype(np.float32)
    a = (rng.uniform(size=lead + (12, 12)) > 0.75).astype(np.float32)
    depth = rng.integers(0, 6, size=lead + (12,)).astype(np.int32)
    mask = (rng.uniform(size=lead + (12,)) > 0.2).astype(np.float32)
    return h, a, depth, mask


@pytest.mark.parametrize("d", [0, 2, 5])
def test_mp_update_full_width_matches_jax(lowering, d):
    H = 32
    p = _bank(H, 5, [2 * H, H, H])
    h, a, depth, mask = _mp_inputs(d, 4, H)
    want = np.asarray(
        jax_mp_update(p, *map(jnp.asarray, (h, a, depth, mask)), jnp.asarray(d, jnp.int32), SLOT_RANGES)
    )
    got = mp_ops.mp_update(
        nn.members(nn.params_from_numpy(p)), _t(h)[None], _t(a), _t(depth), _t(mask), d, SLOT_RANGES
    )[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mp_update_row_span_and_parent_rows_match_jax(lowering):
    H, B, s, e, d = 32, 4, 3, 7, 2
    p = _bank(0, 5, [2 * H, H, H])
    h, a, _, _ = _mp_inputs(11, B, H)
    a[:, s:, s:e] = 0.0  # parents of span rows precede the span
    depth = np.ones((B, 12), np.int32)
    depth[:, s:e] = d
    depth[0, 4] = 1  # one unselected row inside the span
    mask = np.ones((B, 12), np.float32)
    kw = dict(row_span=(s, e), parent_rows=s)
    want = np.asarray(
        jax_mp_update(p, *map(jnp.asarray, (h, a, depth, mask)), jnp.asarray(d, jnp.int32), ((1, s, e),), **kw)
    )
    got = mp_ops.mp_update(
        nn.members(nn.params_from_numpy(p)), _t(h)[None], _t(a), _t(depth), _t(mask), d, ((1, s, e),), **kw
    )[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[0, 4], h[0, 4])


def test_mp_update_shared_skeleton_fields_match_jax(lowering):
    """Shared (N, N) / (N,) fields for a member-stacked (E, B, N, H) state."""
    E, B, H, d = 2, 3, 16, 2
    p = _bank(5, 5, [2 * H, H, H], members=E)
    _, a, depth, mask = _mp_inputs(3, B, H, shared=True)
    h = np.random.default_rng(4).normal(size=(E, B, 12, H)).astype(np.float32)
    want = np.asarray(
        jax.vmap(
            lambda pp, hh: jax_mp_update(pp, hh, *map(jnp.asarray, (a, depth, mask)), jnp.asarray(d, jnp.int32), SLOT_RANGES)
        )(p, jnp.asarray(h))
    )
    got = mp_ops.mp_update(nn.params_from_numpy(p), _t(h), _t(a), _t(depth), _t(mask), d, SLOT_RANGES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mp_update_wrapper_checks():
    p = nn.members(nn.params_from_numpy(_bank(0, 5, [32, 16, 16])))
    h, a, depth, mask = (_t(x) for x in _mp_inputs(0, 2, 16))
    with pytest.raises(TypeError, match="int32"):
        mp_ops.mp_update(p, h[None], a, depth.long(), mask, 1, SLOT_RANGES)
    with pytest.raises(ValueError, match="tile row span"):
        mp_ops.mp_update(p, h[None], a, depth, mask, 1, ((1, 3, 6),), row_span=(3, 7))
    with pytest.raises(ValueError, match="batch"):
        mp_ops.mp_update(p, h[None], a[:1], depth, mask, 1, SLOT_RANGES)
    assert obs.counters().get("mp_update.launches", 0) == 0


def _banded_graphs(seed, trim, n=24):
    """A bucket-padded corpus batch, its banding and the sweep's inputs in
    the banding's layout (trimmed rows for ``exact_banding``)."""
    traces = WorkloadGenerator(seed=seed).corpus(n)
    g = pad_batch(batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces]), bucket_size(n))
    banding = exact_banding(g) if trim else batch_banding(g)
    rows = np.arange(g.op_x.shape[1]) if banding.rows is None else np.asarray(banding.rows)
    a = np.ascontiguousarray(g.a_flow[:, rows][:, :, rows])
    depth = np.ascontiguousarray(g.op_depth[:, rows])
    mask = np.ascontiguousarray(g.op_mask[:, rows])
    levels = gnn._banded_plan(banding, banding.ranges or SLOT_RANGES).levels
    return a, depth, mask, levels


@pytest.mark.parametrize("trim", [False, True], ids=["batch_banding", "exact_banding"])
def test_mp_sweep_matches_jax_on_corpus_bandings(lowering, trim):
    """One sweep over a real banding table (trimmed: parent_rows reaches into
    later levels' spans) == the JAX package's ``mp_sweep``, two members."""
    E, H = 2, 16
    a, depth, mask, levels = _banded_graphs(7, trim)
    assert len(levels) > 1
    p = _bank(3, 5, [2 * H, H, H], members=E)
    h = np.random.default_rng(5).normal(size=(E, a.shape[0], a.shape[1], H)).astype(np.float32)
    want = np.asarray(
        jax.vmap(lambda pp, hh: jax_mp_sweep(pp, hh, *map(jnp.asarray, (a, depth, mask)), levels))(p, jnp.asarray(h))
    )
    got = sweep_ops.mp_sweep(nn.params_from_numpy(p), _t(h), _t(a), _t(depth), _t(mask), levels)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mp_sweep_reads_the_state_before_each_level_writes(lowering):
    """Random graphs whose edges ignore depth, and levels whose parent bound
    covers their own span: every message of a level must come from the state
    the previous level left, never from rows the level itself rewrites."""
    H, B = 16, 4
    p = _bank(9, 5, [2 * H, H, H])
    h, a, depth, mask = _mp_inputs(13, B, H)
    depth = np.random.default_rng(2).integers(1, 4, size=(B, 12)).astype(np.int32)
    levels = (
        (1, (0, 12), SLOT_RANGES, None),
        (2, (3, 11), ((1, 3, 7), (3, 7, 9), (2, 9, 11)), 11),
        (3, (3, 12), ((1, 3, 7), (3, 7, 9), (2, 9, 11), (4, 11, 12)), 12),
    )
    want = np.asarray(jax_mp_sweep(p, *map(jnp.asarray, (h, a, depth, mask)), levels))
    got = sweep_ops.mp_sweep(nn.members(nn.params_from_numpy(p)), _t(h)[None], _t(a), _t(depth), _t(mask), levels)[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mp_sweep_wrapper_checks():
    p = nn.members(nn.params_from_numpy(_bank(0, 5, [32, 16, 16])))
    h, a, depth, mask = (_t(x) for x in _mp_inputs(0, 2, 16))
    assert sweep_ops.mp_sweep(p, h[None], a, depth, mask, ()).data_ptr() == h.data_ptr()  # empty table: h itself
    with pytest.raises(TypeError, match="int32"):
        sweep_ops.mp_sweep(p, h[None], a, depth.long(), mask, ((1, None, SLOT_RANGES, None),))
    with pytest.raises(ValueError, match="tile row span"):
        sweep_ops.mp_sweep(p, h[None], a, depth, mask, ((1, (3, 7), ((1, 3, 6),), 3),))
    with pytest.raises(ValueError, match="parent_rows"):
        sweep_ops.mp_sweep(p, h[None], a, depth, mask, ((1, (3, 7), ((1, 3, 7),), 13),))
    with pytest.raises(NotImplementedError, match="two layers"):
        sweep_ops.mp_sweep({"layers": p["layers"] * 2}, h[None], a, depth, mask, ((1, None, SLOT_RANGES, None),))
    assert obs.counters().get("mp_sweep.launches", 0) == 0


@pytest.mark.parametrize("P,column_slice", [(1, False), (2, False), (2, True)])
def test_gather_sum_matches_jax(lowering, P, column_slice):
    """Stage-2 (P = 1) and stage-3 (P = 2) gathers, two members; the stage-3
    table as a column slice of the full (B, N, P) table (strided rows)."""
    E, B, N, H = 2, 6, 12, 16
    rng = np.random.default_rng(P)
    h = rng.normal(size=(E, B, N, H)).astype(np.float32)
    idx_full = rng.integers(0, N, size=(B, N, P)).astype(np.int64)
    w_full = (rng.uniform(size=(B, N, P)) > 0.4).astype(np.float32)
    s, e = (3, 11) if column_slice else (0, N)
    want = np.asarray(
        jax.vmap(lambda hh: jax_gather_sum(hh, jnp.asarray(idx_full[:, s:e]), jnp.asarray(w_full[:, s:e])))(jnp.asarray(h))
    )
    idx, w = _t(idx_full)[:, s:e], _t(w_full)[:, s:e]
    assert idx.is_contiguous() is not column_slice
    got = seg_ops.gather_sum(_t(h), idx, w)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_segment_sum_matches_jax(lowering):
    E, B, N, H, S = 2, 6, 12, 16, 8
    rng = np.random.default_rng(4)
    x = rng.normal(size=(E, B, N, H)).astype(np.float32)
    seg = rng.integers(0, S, size=(B, N)).astype(np.int64)
    want = np.asarray(jax.vmap(lambda xx: jax_segment_sum(xx, jnp.asarray(seg), S))(jnp.asarray(x)))
    got = seg_ops.segment_sum(_t(x), _t(seg), S)
    assert got.shape == (E, B, S, H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_seg_gather_wrapper_checks():
    h = torch.zeros((1, 2, 12, 8))
    idx = torch.zeros((2, 12, 2), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        seg_ops.gather_sum(h, idx.int(), torch.ones((2, 12, 2)))
    with pytest.raises(ValueError, match="w must be"):
        seg_ops.gather_sum(h, idx, torch.ones((2, 12, 1)))
    with pytest.raises(ValueError, match="seg has shape"):
        seg_ops.segment_sum(h, idx[..., 0][:1], 8)
    with pytest.raises(TypeError, match="float32"):
        seg_ops.segment_sum(h.double(), idx[..., 0], 8)
    assert obs.counters().get("gather_sum.launches", 0) == obs.counters().get("segment_sum.launches", 0) == 0


def _tf32(a: np.ndarray) -> np.ndarray:
    """fp32 rounded to nearest, ties away from zero, at TF32's 10 mantissa
    bits: what ``cvt.rna.tf32.f32`` gives the tensor cores."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """``x @ w`` with TF32 operands: one product of the rounded operands, or
    the 3xTF32 split ``lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w)`` (small
    products first, ``lo(x) lo(w)`` dropped).  Each product of two TF32
    values is exact in fp32; the sums run in fp32."""
    xh, wh = _tf32(x.numpy()), _tf32(w.numpy())
    big = _t(xh) @ _t(wh)
    if not split:
        return big
    xl, wl = _tf32(x.numpy() - xh), _tf32(w.numpy() - wh)
    return (_t(xl) @ _t(wh) + _t(xh) @ _t(wl)) + big


def _tf32_bank(split: bool):
    """``banked_mlp_slotted_ref`` for member-stacked weights with its two
    products in TF32 (``apply_fn`` of ``mp_update_ref``)."""

    def apply(params, x, slot_ranges):
        l1, l2 = params["layers"]
        pieces = []
        for t, s, e in slot_ranges:
            h = torch.relu(_tf32_matmul(x[..., s:e, :], l1["w"][:, t, None], split) + l1["b"][:, t, None, None])
            pieces.append(_tf32_matmul(h, l2["w"][:, t, None], split) + l2["b"][:, t, None, None])
        return torch.cat(pieces, dim=-2)

    return apply


def _deep_corpus_band(n_graphs):
    """The trimmed exact-banding layout (a_flow, depth, mask, levels) of the
    ``n_graphs`` deepest graphs of a 256-trace corpus, under the corpus's own
    level table (a banding holds for every subset of its batch)."""
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in WorkloadGenerator(seed=0).corpus(256)])
    band = exact_banding(g)
    rows = np.asarray(band.rows)
    pick = np.argsort(-g.op_depth.max(axis=1), kind="stable")[:n_graphs]
    a = g.a_flow[pick][:, rows][:, :, rows]
    depth, mask = g.op_depth[pick][:, rows], g.op_mask[pick][:, rows]
    return _t(a), _t(depth), _t(mask), gnn._banded_plan(band, band.ranges).levels


@pytest.mark.parametrize("scale", ["glorot", "0.2"])
def test_sweep_chain_conditioning_by_weight_scale(scale):
    """Why the sweep's card tests hold the kernel against an fp64 evaluation
    at 0.2 x randn, and against the plain version at glorot scale: over the
    six chained levels of estimate_many's banding, the plain fp32 sweep stays
    well within ``TOL`` of fp64 at the model's init scale, and is itself
    outside it at 0.2 x randn, where no reordered fp32 sum (such as the
    kernel's) could be held to ``TOL`` of the plain version."""
    a, depth, mask, levels = _deep_corpus_band(16)
    gen = torch.Generator().manual_seed(0)
    E, H, T = 2, 64, 5

    def w(fan_in, fan_out):
        std = 0.2 if scale == "0.2" else (2.0 / (fan_in + fan_out)) ** 0.5
        return std * torch.randn((E, T, fan_in, fan_out), generator=gen)

    p = {"layers": [{"w": w(2 * H, H), "b": 0.2 * torch.randn((E, T, H), generator=gen)},
                    {"w": w(H, H), "b": 0.2 * torch.randn((E, T, H), generator=gen)}]}
    h = torch.randn((E, a.shape[0], a.shape[1], H), generator=gen)
    fp32 = mp_sweep_ref(p, h, a, depth, mask, levels).double()
    p64 = {"layers": [{k: v.double() for k, v in layer.items()} for layer in p["layers"]]}
    exact = mp_sweep_ref(p64, h.double(), a.double(), depth, mask.double(), levels)
    ratio = float(((fp32 - exact).abs() / (TOL["atol"] + TOL["rtol"] * exact.abs())).max())
    assert (ratio < 0.5) if scale == "glorot" else (ratio > 1.0), ratio


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "tf32"])
@pytest.mark.parametrize("case", ["op_upd", "mp_update", "sweep"])
def test_tf32_split_holds_the_kernel_tolerance(case, split):
    """Why the tensor-core MLP tile (``csrc/mma_tile.cuh``) splits each fp32
    operand into two TF32 values: at the main path's widths (op_upd: F = 128,
    H = 64; an mp_update scan step and the fused sweep: H = 64), glorot
    weights and ``randn`` inputs, the 3xTF32 products stay within ``TOL`` of
    the fp32 plain version and a single TF32 product does not.  The sweep
    chains estimate_many's six banding levels (parents inside the span from
    level 3 on), so each level's error feeds the next."""
    E, B, N, H = 2, 16, 12, 64
    rng = np.random.default_rng(14)
    p = nn.params_from_numpy(_bank(14, 5, [2 * H, H, H], members=E))
    h = _t(rng.normal(size=(E, B, N, 2 * H if case == "op_upd" else H)).astype(np.float32))
    if case == "op_upd":
        want = banked_mlp_slotted_ref(p, h, SLOT_RANGES)
        got = _tf32_bank(split)(p, h, SLOT_RANGES)
    elif case == "sweep":
        a, depth, mask, levels = _deep_corpus_band(B)
        assert len(levels) == 6 and all(lv[3] > lv[1][0] for lv in levels[2:])
        h = h[:, :, : a.shape[1]].contiguous()
        want = mp_sweep_ref(p, h, a, depth, mask, levels)
        got = mp_sweep_ref(p, h, a, depth, mask, levels, apply_fn=_tf32_bank(split))
        assert all(bool(((depth == lv[0]) & (mask > 0)).any()) for lv in levels)  # every level updates rows
    else:
        _, a, depth, mask = (_t(x) for x in _mp_inputs(14, B, H))
        depth = _t(rng.integers(1, 3, size=(B, N)).astype(np.int32))
        want = mp_ops.mp_update(p, h, a, depth, mask, 2, SLOT_RANGES)
        got = mp_update_ref(p, h, a, depth, mask, 2, SLOT_RANGES, apply_fn=_tf32_bank(split))
    err = float((got - want).abs().max())
    assert err > 0.0
    within = bool(torch.allclose(got, want, **TOL))
    assert within is split, f"max abs err {err} against TOL {TOL}"


@pytest.mark.parametrize("H,H1", [(12, 16), (16, 20), (5, 3), (100, 128), (128, 1)])
@pytest.mark.parametrize("kernel", ["banked_mlp", "mp_update", "mp_sweep"])
def test_zero_padded_widths_compute_the_same_function(kernel, H, H1):
    """What the CUDA wrappers launch at a width that is no multiple of 8: the
    bank zero-padded to multiples of 8 (``common.pad_widths``; for the stage-3
    kernels also the state, whose two halves of ``[h, msg]`` move apart),
    trimmed back to the real columns, is the plain version of the unpadded
    bank, and its padded columns stay zero.  Checked here on the plain
    versions; ``test_torch_cuda.py`` holds the kernels at these widths."""
    from repro_torch.kernels.common import pad_widths, round8

    gen = torch.Generator().manual_seed(H * 131 + H1)
    E, B, N, T = 2, 9, 12, 5

    def bank(F, H1, H2):
        return [0.3 * torch.randn(s, generator=gen) for s in ((E, T, F, H1), (E, T, H1), (E, T, H1, H2), (E, T, H2))]

    def layers(w1, b1, w2, b2):
        return {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}

    if kernel == "banked_mlp":
        x = torch.randn((E, B, N, 7), generator=gen)
        w = bank(7, H, H1)
        want = banked_mlp_slotted_ref(layers(*w), x, SLOT_RANGES)
        got = banked_mlp_slotted_ref(layers(*pad_widths(*w)), x, SLOT_RANGES)
        width = H1
    else:
        w = bank(2 * H, H1, H)
        h = torch.randn((E, B, N, H), generator=gen)
        a = (torch.rand((B, N, N), generator=gen) > 0.6).float()
        depth = torch.randint(1, 4, (B, N), generator=gen, dtype=torch.int32)
        mask = (torch.rand((B, N), generator=gen) > 0.2).float()
        hp = torch.nn.functional.pad(h, (0, round8(H) - H))
        if kernel == "mp_update":
            want = mp_update_ref(layers(*w), h, a, depth, mask, 2, SLOT_RANGES)
            got = mp_update_ref(layers(*pad_widths(*w, state=H)), hp, a, depth, mask, 2, SLOT_RANGES)
        else:
            levels = ((1, (0, N), SLOT_RANGES, N), (2, (3, 11), ((1, 3, 7), (3, 7, 9), (2, 9, 11)), 11))
            want = mp_sweep_ref(layers(*w), h, a, depth, mask, levels)
            got = mp_sweep_ref(layers(*pad_widths(*w, state=H)), hp, a, depth, mask, levels)
        width = H
    assert got.shape[-1] == round8(width)
    torch.testing.assert_close(got[..., :width], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[..., width:], torch.zeros_like(got[..., width:]))
