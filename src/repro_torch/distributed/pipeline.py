"""Pipeline parallelism: a GPipe-style microbatch pipeline over a
``torch.distributed`` process group (port of ``repro/distributed/pipeline.py``).

Ranks are stages.  Activations move stage k -> k+1 by point-to-point
``isend`` / ``irecv``; the schedule is the JAX package's fill-run-drain loop:
with M microbatches and K stages it runs M + K - 1 ticks, stage k is active
at tick t when 0 <= t - k < M, and stage 0 ingests microbatch t.  The bubble
fraction is (K - 1) / (M + K - 1).  Forward only, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import nn


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], group=None):
    """Returns ``pipelined(params_stacked, xs)``.

    ``params_stacked``: a tree whose leaves have a leading dim of K = the
    group's size; rank k runs ``stage_fn(leaf[k] for each leaf, x)``, whose
    output has ``x``'s shape and dtype.  ``xs``: (M, mb, ...) microbatches,
    the same on every rank (only stage 0 reads them).  Returns the last
    stage's (M, mb, ...) outputs on every rank.  ``group=None`` is the default
    process group.
    """

    def pipelined(params_stacked, xs: torch.Tensor) -> torch.Tensor:
        if not dist.is_initialized():
            raise RuntimeError("pipeline_forward: no torch.distributed process group is initialized")
        n_stages, k = dist.get_world_size(group), dist.get_rank(group)

        def rank_of(stage: int) -> int:  # p2p and broadcast name global ranks
            return stage if group is None else dist.get_global_rank(group, stage)

        params = nn.tree_map(lambda p: p[k], params_stacked)
        M = xs.shape[0]
        outs = torch.zeros_like(xs)
        sends = []
        for t in range(M + n_stages - 1):
            m = t - k
            if not 0 <= m < M:
                continue
            if k == 0:
                x_in = xs[m]
            else:
                x_in = torch.empty_like(xs[0])
                dist.irecv(x_in, src=rank_of(k - 1), group=group).wait()
            y = stage_fn(params, x_in)
            if k < n_stages - 1:
                y = y.contiguous()
                sends.append((dist.isend(y, dst=rank_of(k + 1), group=group), y))  # y lives until sent
            else:
                outs[m] = y
        for work, _ in sends:
            work.wait()
        if n_stages > 1:  # only the last stage holds real outputs
            dist.broadcast(outs, src=rank_of(n_stages - 1), group=group)
        return outs

    return pipelined
