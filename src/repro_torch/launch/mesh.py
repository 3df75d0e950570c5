"""Production mesh construction (port of ``repro/launch/mesh.py``).

The JAX package's mesh shapes and axis names, on H100 SXM 80 GB cards: a
single pod is 256 GPUs as a (data=16, model=16) mesh; multi-pod is 512 GPUs as
(pod=2, data=16, model=16), the pod axis extending data parallelism.  So a dry
run cell is the same cell in both packages.

The dry run runs in one process: a ``DeviceMesh`` over a ``fake`` process
group, whose collectives move nothing, with the parameters and inputs as
DTensors on the ``meta`` device.  One process has one default group, so each
mesh re-creates it at the mesh's size (``fake_world``); a mesh built before
is not used after the next one is built.  Importing this module touches no
distributed state.

Hardware constants per GPU (NVIDIA's data sheet for the H100 SXM at its 700 W
limit, dense rates):

* ``PEAK_FLOPS_BF16`` 989e12 FLOP/s on the tensor cores;
* ``HBM_BW`` 3.35e12 B/s;
* ``NVLINK_BW`` 450e9 B/s each way between the 8 GPUs of a node (NVLink 4);
* ``NET_BW`` 50e9 B/s between nodes (one 400 Gb/s network link per GPU).

Ranks fill nodes of ``GPUS_PER_NODE`` in order and ``model`` is the innermost
mesh axis, so rank = (pod * 16 + data) * 16 + model.  A collective is charged
at the slowest link its group crosses: NVLink when every rank of the group
sits in one node, the network otherwise.  A 16-wide ``model`` group spans two
nodes, and a ``data`` or ``pod`` group strides across nodes, so on the
production meshes every collective is charged at ``NET_BW``; on a mesh of at
most 8 GPUs every one is charged at ``NVLINK_BW``.

The JAX module's ``TPU_PERF_FLAGS`` (XLA's async-collective flags) have no
counterpart: PyTorch runs eagerly and compiles nothing for the mesh.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

PEAK_FLOPS_BF16 = 989e12  # per GPU
HBM_BW = 3.35e12  # bytes/s per GPU
NVLINK_BW = 450e9  # bytes/s each way, within a node
NET_BW = 50e9  # bytes/s per GPU, between nodes
GPUS_PER_NODE = 8


def fake_world(size: int) -> None:
    """Make the default process group a ``fake`` one of ``size`` ranks, this
    process rank 0, re-creating an earlier fake group of another size.  A
    default group of another backend (a real run's) is left alone: raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is the default; "
                               "the dry run needs its own process")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A named ``DeviceMesh`` of ``shape`` over a fake group of its size.

    Its device type is ``cpu``, the one that also works in a process whose
    torch has no CUDA (the tensors on it are ``meta`` either way).  On a
    ``cpu`` mesh DTensor re-shards Shard(i) -> Shard(j) by an all-gather and a
    local chunk, where on GPUs it runs an all-to-all (gloo has none): such a
    re-shard counts as an all-gather of the group size times the bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def n_chips(mesh) -> int:
    return int(mesh.size())


def link_bw(ranks: Sequence[int]) -> Tuple[str, float]:
    """The slowest link a collective over ``ranks`` crosses: ("nvlink", 450e9)
    within one node, ("network", 50e9) across nodes."""
    if len({r // GPUS_PER_NODE for r in ranks}) <= 1:
        return "nvlink", NVLINK_BW
    return "network", NET_BW
