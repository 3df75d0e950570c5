"""Optimizers and schedules over param trees, with the JAX package's formulas.

The port of ``repro/training/optim.py``: a functional API, ``opt.init(params)
-> state`` and ``opt.update(grads, state, params) -> (updates, state)``,
applied with ``apply_updates``.  Params, grads and states are trees of
tensors (nested dicts and lists, ``nn.tree_map``); every state is a
NamedTuple whose field names are the JAX package's, so a checkpoint of it
has the same keys (``1/step``, ``1/mu/...``).  ``torch.optim`` and
``torch.nn.utils.clip_grad_norm_`` are not used: JAX's clip scales by
``min(1, max_norm / max(norm, 1e-9))`` over one global norm, its schedule is
read at ``step + 1``, and its weight decay is the decoupled ``-lr_t * wd *
p``.  The step counter and every scalar stay float32 / int32 tensors on the
params' device, so an update never waits on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import nn

PyTree = object


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], Tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return nn.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# -- schedules -------------------------------------------------------------------


def constant_schedule(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def cosine_schedule(
    peak_lr: float, total_steps: int, warmup_steps: int = 0, final_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


# -- gradient transforms -----------------------------------------------------------


def global_norm(tree: PyTree) -> torch.Tensor:
    """One norm over every leaf, summed in the JAX package's leaf order."""
    leaves = nn.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` multiplies every leaf by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    scale = clip_scale(global_norm(tree), max_norm)
    return nn.tree_map(lambda x: x * scale, tree)


# -- Adam / AdamW --------------------------------------------------------------------


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=nn.tree_leaves(params)[0].device)


def adam(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
    moment_dtype=torch.float32,
) -> Optimizer:
    """Adam(W). ``weight_decay`` > 0 gives decoupled AdamW decay."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return AdamState(step=_step0(params), mu=nn.tree_map(zeros, params), nu=nn.tree_map(zeros, params))

    def update(grads, state, params=None):
        if max_grad_norm is not None:
            grads = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        b1t = 1.0 - b1 ** step.to(torch.float32)
        b2t = 1.0 - b2 ** step.to(torch.float32)
        lr_t = sched(step)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m2 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v2 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
            mhat = m2 / b1t
            vhat = v2 / b2t
            delta = -lr_t * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay > 0.0 and p is not None:
                delta = delta - lr_t * weight_decay * p.to(torch.float32)
            return delta, m2.to(moment_dtype), v2.to(moment_dtype)

        like = params if params is not None else grads
        deltas, mu, nu = nn.tree_map_n(
            lambda g, m, v, p: upd(g, m, v, p if params is not None else None), 3, grads, state.mu, state.nu, like
        )
        return deltas, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def adamw(
    lr: float | Callable = 1e-3,
    weight_decay: float = 0.01,
    **kw,
) -> Optimizer:
    return adam(lr=lr, weight_decay=weight_decay, **kw)


# -- SGD (used by tests & the monitoring baseline) --------------------------------------


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return SGDState(
            step=_step0(params),
            momentum=nn.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        )

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = sched(step)

        def upd(g, m):
            m2 = momentum * m + g.to(torch.float32)
            return -lr_t * m2, m2

        deltas, mom = nn.tree_map_n(upd, 2, grads, state.momentum)
        return deltas, SGDState(step=step, momentum=mom)

    return Optimizer(init=init, update=update)
