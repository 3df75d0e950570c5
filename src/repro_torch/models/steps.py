"""Train and serving steps for the LM stack (port of ``repro/models/steps.py``).

``make_train_step`` builds the training step: forward, next-token cross
entropy, gradients, Adam(W) with global-norm clipping.  ``make_serve_step``
builds the cached step: prefill a batch of prompts into the decode cache
(``cache_len=0``, S prompt tokens) or decode one token per request.
``make_prefill_step`` runs a prompt once without a cache, under
``torch.no_grad`` as the serving step does.  A batch holds ``tokens`` and,
for a vision model, ``vis_embeds`` (B, V, d) or, for an encoder-decoder,
``frames`` (B, S_enc, d); the serving step takes tokens only, as in the JAX
package (a vision prompt is prefilled through ``transformer.forward`` with
the cache, an encoder-decoder's cache filled by ``blocks.cross_kv``).  Each
runs on the GPU unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import nn
from repro_torch.models.sharding_ctx import batch_only
from repro_torch.models.transformer import ModelConfig, forward
from repro_torch.training import optim

Params = Dict[str, Any]


def _on(x, device: torch.device) -> torch.Tensor:
    """An input (token ids, patch embeddings, frames) as a tensor on
    ``device``; a host array is copied, never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _frontend(batch: Dict[str, Any], device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """``vis_embeds`` and ``frames`` of ``batch`` (None where absent) as tensors on ``device``."""
    return {k: None if batch.get(k) is None else _on(batch[k], device) for k in ("vis_embeds", "frames")}


def _check_params(params: Params, device: torch.device) -> None:
    where = params["embed"].device
    if where.type != device.type or (device.index is not None and where.index != device.index):
        raise ValueError(f"the parameters are on {where}, the step runs on {device}; move them first")


def _leaves(tree):
    return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]


# -- training ------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) float32; targets (B, S) int -> scalar mean NLL.

    The gold logit is a gather where the JAX package sums ``logits *
    one_hot``: the same value (the sum has one nonzero term), without a
    (B, S, V) one-hot tensor as large as the logits.  Logits whose vocab
    dimension a mesh splits (a DTensor, in the dry run) take the JAX
    package's sum instead, over a comparison mask that is sharded like them:
    each rank sums its own columns and DTensor all-reduces (B, S) values,
    where its gather across shards fails."""
    logz = torch.logsumexp(logits, dim=-1)
    if _vocab_split(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(targets[..., None] == vocab, logits, 0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, targets.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)


def _vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor whose last dimension is sharded over a
    mesh dimension of more than one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(p.is_shard(logits.ndim - 1) and mesh.size(i) > 1 for i, p in enumerate(logits.placements))


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Next-token prediction loss of ``batch["tokens"]`` (B, S), a tensor or a
    host array (copied to the parameters' device), within the token region:
    the logits of a ``vis_embeds`` prefix are dropped."""
    device = params["embed"].device
    tokens = _on(batch["tokens"], device)
    extra = _frontend(batch, device)
    logits, _ = forward(params, cfg, tokens, **extra)
    if extra["vis_embeds"] is not None:
        logits = logits[:, extra["vis_embeds"].shape[1] :, :]
    return cross_entropy(logits[:, :-1, :], tokens[:, 1:])


@dataclass(frozen=True)
class TrainStepConfig:
    lr: float = 3e-4
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32


def make_optimizer(tcfg: TrainStepConfig) -> optim.Optimizer:
    return optim.adam(
        lr=tcfg.lr,
        weight_decay=tcfg.weight_decay,
        max_grad_norm=tcfg.max_grad_norm,
        moment_dtype=tcfg.moment_dtype,
    )


def lm_loss_and_grads(params: Params, cfg: ModelConfig, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Params]:
    """``(lm_loss, its gradient)`` at ``params`` (a tree like it, in the parameters' dtypes)."""
    live = nn.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, batch)
    grads = iter(torch.autograd.grad(loss, _leaves(live)))
    return loss.detach(), nn.tree_map(lambda _: next(grads), params)


def apply_update(tcfg: TrainStepConfig, grads: Params, opt_state: optim.AdamState, params: Params,
                 grad_norm: torch.Tensor) -> Tuple[Params, optim.AdamState]:
    """``make_optimizer(tcfg).update`` then ``optim.apply_updates``, with the
    same numbers, one leaf at a time: each leaf's clipped gradient and float32
    update are freed before the next leaf's are made, where a whole float32
    update tree would sit beside both the old and the new moments (at
    RecurrentGemma-2B's full width, twice the bf16 parameters' bytes).
    ``grad_norm`` is the global norm of ``grads``.  A bfloat16 gradient is
    clipped in float32, as JAX promotes a bf16 leaf times the float32 scale."""
    leaf_opt = optim.adam(lr=tcfg.lr, weight_decay=tcfg.weight_decay, moment_dtype=tcfg.moment_dtype)
    scale = None if tcfg.max_grad_norm is None else optim.clip_scale(grad_norm, tcfg.max_grad_norm)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(_leaves(grads), _leaves(opt_state.mu), _leaves(opt_state.nu), _leaves(params)):
        if scale is not None:
            g = g.to(torch.float32) * scale
        delta, st = leaf_opt.update(g, optim.AdamState(opt_state.step, m, v), p)
        new_p.append((p + delta).to(p.dtype))
        new_m.append(st.mu)
        new_v.append(st.nu)
        del g, delta, st

    def rebuild(leaves):
        it = iter(leaves)
        return nn.tree_map(lambda _: next(it), params)

    return rebuild(new_p), optim.AdamState(step=opt_state.step + 1, mu=rebuild(new_m), nu=rebuild(new_v))


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig = TrainStepConfig(), device=None):
    """``(train_step, opt)``: ``train_step(state, batch) -> (state, {"loss",
    "grad_norm"})`` over ``state = {"params", "opt": opt.init(params), "step"}``;
    the grad norm is the unclipped one.  The state is not modified in place."""
    device = nn.resolve_device(device, "train_step")
    opt = make_optimizer(tcfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        _check_params(params, device)
        loss, grads = lm_loss_and_grads(params, cfg, batch)
        norm = optim.global_norm(grads)
        params, opt_state = apply_update(tcfg, grads, state["opt"], params, norm)
        return {"params": params, "opt": opt_state, "step": state["step"] + 1}, {"loss": loss, "grad_norm": norm}

    return train_step, opt


# -- serving -------------------------------------------------------------------------


def make_serve_step(cfg: ModelConfig, device=None):
    """One cached step: (params, cache, tokens (B, S), cache_len) ->
    (logits (B, S, V) float32, new_cache, next_token (B, 1) int32), the next
    token greedy from the last position.  ``tokens`` may be a host array; it
    goes to the step's device."""
    device = nn.resolve_device(device, "serve_step")

    def serve_step(params: Params, cache: Params, tokens, cache_len: int):
        _check_params(params, device)
        tokens = _on(tokens, device)
        with torch.no_grad():
            logits, new_cache = forward(params, cfg, tokens, cache=cache, cache_len=cache_len)
        # whole rows for the argmax: DTensor's argmax across vocab shards fails at a batch of 1
        next_tok = torch.argmax(batch_only(logits[:, -1, :]), dim=-1).to(torch.int32)[:, None]
        return logits, new_cache, next_tok

    return serve_step


def make_prefill_step(cfg: ModelConfig, device=None):
    """Prefill without a cache: (params, {"tokens": (B, S)[, "vis_embeds" |
    "frames"]}) -> the last position's logits (B, 1, V) float32."""
    device = nn.resolve_device(device, "prefill_step")

    def prefill_step(params: Params, batch: Dict[str, Any]):
        _check_params(params, device)
        with torch.no_grad():
            logits, _ = forward(params, cfg, _on(batch["tokens"], device), **_frontend(batch, device))
        return logits[:, -1:, :]

    return prefill_step
