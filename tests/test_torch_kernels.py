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
from repro.kernels.mp_update.ops import mp_update as jax_mp_update
from repro_torch import nn
from repro_torch.kernels.banked_mlp import ops as bank_ops
from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
from repro_torch.kernels.mp_update import ops as mp_ops

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
    assert bank_ops.banked_mlp_slotted.launches == 0  # the CPU never launches


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
    assert mp_ops.mp_update.launches == 0
