"""Elastic scaling: re-shard a training state onto another mesh (port of
``repro/training/elastic.py``).

On node failure the launcher rebuilds a smaller mesh from the surviving hosts
and resumes from the latest checkpoint; on capacity recovery it grows back.
Checkpoints hold full (unsharded) host arrays, so re-sharding places each
leaf anew: ``distribute_tensor`` with the new mesh's placements
(``models.params.shardings``, whose rules re-resolve against the new mesh
sizes), or a copy to a plain device.  A mesh here is a named ``DeviceMesh``
or a mapping of axis name to size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.models.params import NamedSharding, mesh_shape


def _place(x, target) -> torch.Tensor:
    host = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if isinstance(target, NamedSharding):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(host.to(target.mesh.device_type), target.mesh, list(target.placements))
    return host.to(torch.device(target), copy=True)


def reshard_state(state, target_shardings):
    """Place a host-side tree (tensors or numpy arrays) by a tree of the same
    structure whose leaves are ``NamedSharding``s or devices."""
    return nn.tree_map(_place, state, target_shardings)


def shrink_mesh_shape(shape: Tuple[int, ...], axes: Tuple[str, ...], axis: str, by: int) -> Tuple[int, ...]:
    """Shrink one mesh axis (e.g. lose a data-parallel slice); raises
    ``ValueError`` unless ``by`` divides it."""
    out = []
    for a, s in zip(axes, shape):
        if a == axis:
            if s % by != 0 or s // by < 1:
                raise ValueError(f"cannot shrink mesh axis {a!r} of size {s} by {by}")
            out.append(s // by)
        else:
            out.append(s)
    return tuple(out)


def validate_global_batch(global_batch: int, mesh, data_axes=("pod", "data")) -> int:
    """Per-replica batch after an elastic change; raises ``ValueError`` if indivisible."""
    shape = mesh_shape(mesh)
    n = 1
    for a in data_axes:
        if a in shape:
            n *= shape[a]
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data parallelism {n}")
    return global_batch // n
