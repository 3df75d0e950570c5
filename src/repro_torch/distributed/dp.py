"""Data-parallel train step with an explicit gradient reduction (port of
``repro/distributed/dp.py``).

Each rank of a ``torch.distributed`` process group holds the whole state
(parameters and optimizer state, replicated: ZeRO-0) and its own share of the
batch.  A step runs

  local loss and grads -> [int8 quantize -> dequantize] -> all_reduce(SUM) / world -> update

leaf by leaf over the parameter tree, as the JAX package's ``psum`` under
``shard_map`` does.  The port's parameters are trees of tensors, not
``nn.Module``s, so the reduction is written out rather than left to a DDP
communication hook.  The wire carries the dequantized float32 sum, as the
JAX package's ``psum`` of the dequantized value does; moving the int8 values
and their scales themselves is a later speed question.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import nn
from repro_torch.training import optim
from repro_torch.training.compression import int8_dequantize, int8_quantize


def _leaves(tree):
    return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]


def _rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rounding-noise generator of one rank at one step: the counterpart
    of JAX's ``fold_in(key, axis_index)``, a distinct stream per (seed, rank)."""
    return torch.Generator(device).manual_seed((int(seed) << 20) ^ int(rank))


def make_dp_train_step(
    loss_fn: Callable,  # (params, batch) -> scalar loss
    opt: optim.Optimizer,
    group=None,
    compression: Optional[str] = None,  # None | "int8"
):
    """Returns ``train_step(state, batch, seed) -> (state, {"loss"})``.

    ``state = {"params", "opt": opt.init(params), "step"}`` is the same on
    every rank; ``batch`` is this rank's share, which ``loss_fn`` averages
    over.  ``seed`` (an int) seeds the int8 rounding noise, with the rank
    folded in.  ``group=None`` is the default process group, which must be
    initialized.  The returned loss is the mean over ranks.
    """
    if compression not in (None, "int8"):
        raise ValueError(f"compression {compression!r}: want None or 'int8'")

    def train_step(state: Dict[str, Any], batch, seed: int):
        if not dist.is_initialized():
            raise RuntimeError("make_dp_train_step: no torch.distributed process group is initialized")
        world = dist.get_world_size(group)
        params = state["params"]
        live = nn.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        grads = [g.contiguous() for g in torch.autograd.grad(loss, _leaves(live))]
        loss = loss.detach().clone()
        if compression == "int8":
            gen = _rank_generator(seed, dist.get_rank(group), loss.device)
            grads = [int8_dequantize(*int8_quantize(g, gen, stochastic=True)) for g in grads]
        for t in grads + [loss]:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(world)
        it = iter(grads)
        updates, opt_state = opt.update(nn.tree_map(lambda _: next(it), params), state["opt"], params)
        params = optim.apply_updates(params, updates)
        return {"params": params, "opt": opt_state, "step": state["step"] + 1}, {"loss": loss}

    return train_step
