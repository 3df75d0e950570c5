"""Training of the nine architectures beside RecurrentGemma against the JAX package.

For each reduced config (``internlm2-1.8b``, ``qwen3-8b``, ``deepseek-67b``,
``gemma2-2b``, ``arctic-480b``, ``deepseek-v2-236b``, ``xlstm-125m``,
``internvl2-1b`` with its ``vis_embeds`` prefix, ``whisper-base`` with its
encoder frames), from JAX-made float32 weights carried across with
``nn.params_from_numpy`` and the same numpy batch:

* ``lm_loss_and_grads`` against ``jax.value_and_grad`` of JAX's ``lm_loss``:
  the loss within ``rtol=1e-5``, each gradient leaf within ``1e-5`` of that
  leaf's largest JAX entry (a leaf's small entries are sums of terms of its
  large ones' size), every leaf nonzero in both packages;
* three ``make_train_step`` steps against JAX's: loss and grad norm within
  ``rtol=1e-5`` at each step.

And the remat policies ``"full"`` and ``"dots"`` against ``"none"`` on the
encoder-decoder and on the MLA / MoE model, with a short attention block
so that the blocked, checkpointed attention nests inside each group.
``tests/test_torch_lm_train.py`` holds RecurrentGemma's training.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import base as jconfigs
from repro.models import params as jparams
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs, nn
from repro_torch.models import blocks, steps

ARCHS = ("internlm2-1.8b", "qwen3-8b", "deepseek-67b", "gemma2-2b", "arctic-480b", "deepseek-v2-236b",
         "xlstm-125m", "internvl2-1b", "whisper-base")
STEP_TOL = dict(rtol=1e-5)  # a step's loss and grad norm: means and norms over many terms
GRAD_REL = 1e-5  # a gradient leaf, against its largest JAX entry


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reduced(arch, remat="none"):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), remat=remat)
    jp = jparams.materialize(jax.random.PRNGKey(0), jtf.model_defs(jcfg), dtype_override=jnp.float32)
    return jcfg, cfg, jp, nn.params_from_numpy(_np(jp))


def _batch(cfg, seed=3, length=16):
    """2 x ``length`` tokens (past the reduced window of 8), with the
    config's frontend input: 8 patch embeddings or 16 encoder frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, length)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["vis_embeds"] = rng.standard_normal((2, cfg.vis_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jp, tp = _reduced(arch)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jsteps.lm_loss(p, jcfg, b)))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    loss, grads = steps.lm_loss_and_grads(tp, cfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    worst = []

    def leaf(path, g):
        want = np.asarray(_at(jgrads, path))
        scale = float(np.abs(want).max())
        assert scale > 0 and bool(g.abs().max() > 0), f"{'/'.join(path)}: a zero gradient"
        worst.append(float(np.abs(g.numpy() - want).max()) / scale)

    nn.tree_map_with_path(leaf, grads)
    assert len(worst) == len(jax.tree_util.tree_leaves(jgrads)) and max(worst) <= GRAD_REL, max(worst)


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Three steps of ``make_train_step`` (Adam with clipping and weight
    decay) against the JAX package's, from the same weights and batch."""
    jcfg, cfg, jp, tp = _reduced(arch)
    jstep, jopt = jsteps.make_train_step(jcfg, jsteps.TrainStepConfig())
    tstep, topt = steps.make_train_step(cfg, steps.TrainStepConfig(), device="cpu")
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": topt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(cfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstep = jax.jit(jstep)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **STEP_TOL, err_msg=f"step {i}")
    assert int(tstate["step"]) == 3 and int(tstate["opt"].step) == 3
    assert float(tm["loss"]) < float(steps.lm_loss(tp, cfg, batch))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["whisper-base", "deepseek-v2-236b"])
def test_remat_policies_give_the_same_loss_and_grads(arch, remat, monkeypatch):
    """``remat`` changes what the backward keeps, not what it computes: the
    loss and every gradient leaf equal those without remat, for the
    encoder's groups and the decoder's (whose cross-attention reads the
    encoder output through the checkpoint) and for MLA with the MoE."""
    monkeypatch.setattr(blocks, "ATTN_BLOCK", 8)
    _, cfg, _, tp = _reduced(arch)
    batch = _batch(cfg, seed=4, length=20)
    want_loss, want = steps.lm_loss_and_grads(tp, cfg, batch)
    loss, got = steps.lm_loss_and_grads(tp, dataclasses.replace(cfg, remat=remat), batch)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    nn.tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6), got, want)
