"""Serving steps for the LM stack (port of ``repro/models/steps.py``).

``make_serve_step`` builds the cached step: prefill a batch of prompts into
the decode cache (``cache_len=0``, S prompt tokens) or decode one token per
request.  ``make_prefill_step`` runs a prompt once without a cache.  Both
run on the GPU unless the caller asks for ``device="cpu"``, under
``torch.no_grad``.  The training step (``cross_entropy``, ``lm_loss``,
``make_train_step``) comes with LM training (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import nn
from repro_torch.models.transformer import ModelConfig, forward

Params = Dict[str, Any]


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    """Token ids as a tensor on ``device``; a host array is copied, never aliased."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device)
    return torch.tensor(np.asarray(tokens), device=device)


def _check_params(params: Params, device: torch.device) -> None:
    where = params["embed"].device
    if where.type != device.type or (device.index is not None and where.index != device.index):
        raise ValueError(f"the parameters are on {where}, the step runs on {device}; move them first")


def make_serve_step(cfg: ModelConfig, device=None):
    """One cached step: (params, cache, tokens (B, S), cache_len) ->
    (logits (B, S, V) float32, new_cache, next_token (B, 1) int32), the next
    token greedy from the last position.  ``tokens`` may be a host array; it
    goes to the step's device."""
    device = nn.resolve_device(device, "serve_step")

    def serve_step(params: Params, cache: Params, tokens, cache_len: int):
        _check_params(params, device)
        tokens = _tokens(tokens, device)
        with torch.no_grad():
            logits, new_cache = forward(params, cfg, tokens, cache=cache, cache_len=cache_len)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return logits, new_cache, next_tok

    return serve_step


def make_prefill_step(cfg: ModelConfig, device=None):
    """Prefill without a cache: (params, {"tokens": (B, S)}) -> the last
    position's logits (B, 1, V) float32."""
    device = nn.resolve_device(device, "prefill_step")

    def prefill_step(params: Params, batch: Dict[str, Any]):
        _check_params(params, device)
        if batch.keys() - {"tokens"}:
            raise NotImplementedError(
                f"prefill_step: inputs {sorted(batch.keys() - {'tokens'})} need a modality frontend, "
                "not ported yet (ROADMAP queue 1, item 10)"
            )
        with torch.no_grad():
            logits, _ = forward(params, cfg, _tokens(batch["tokens"], device))
        return logits[:, -1:, :]

    return prefill_step
