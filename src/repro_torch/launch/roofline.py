"""Roofline analysis (port of ``repro/launch/roofline.py``).

The three roofline terms of one step, per GPU, from counts taken while the
step runs on DTensors over the ``meta`` device (``launch/mesh.py``):

  compute term    = FLOPs             / PEAK_FLOPS_BF16
  memory term     = bytes             / HBM_BW
  collective term = sum over collectives of bytes / the slowest link its group crosses

The JAX package reads these from XLA's ``cost_analysis`` and parses the
collectives out of the optimized HLO text.  PyTorch compiles nothing, so
``Counter`` counts instead: a ``TorchDispatchMode`` that steps aside for
DTensor ops (returns ``NotImplemented``), so that DTensor runs its sharding
propagation and then issues the LOCAL ops and the functional collectives that
the mode does see, on each rank's shards.  So every count is per GPU (this
process is rank 0 of a fake group), and a matmul whose contraction dimension
is sharded counts its partial-sum work on the shard; the all-reduce that
DTensor issues to finish it counts as a collective.

* FLOPs: ``torch.utils.flop_counter.flop_registry``'s formulas (matmuls,
  convolutions, attention), plus what a kernel's meta branch charges
  (``charge_kernel``: ``linear_scan``'s 2 B T D).  Elementwise work counts
  no FLOPs, as in ``FlopCounterMode``.
* Bytes: each aten op's tensor inputs read once (an expanded view: its
  storage) and outputs written once, the traffic of the port's eager step.  Views, metadata ops and ``empty`` count
  nothing; gather-like ops (``index``, ``embedding``, ``index_select``,
  ``gather``) read the rows they gather (their output's size) and their
  indices, not the whole table.  Collectives count here as collectives only.
* Collective bytes by kind: the result bytes of each functional collective,
  under the JAX package's five names plus ``count``, and by link.
* Memory: the peak of the live bytes of the storages that the step's ops
  create (``temp_peak``), outputs included while they exist.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16, link_bw

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

LINKS = {"nvlink": NVLINK_BW, "network": NET_BW}

_aten = torch.ops.aten
# ops that move no data: they allocate without writing, or read metadata only
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten._unsafe_view, _aten.lift_fresh, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.is_same_size,
}
# ops that read only the rows they gather: their output's size, and their indices
_GATHERS = {_aten.index, _aten.embedding, _aten.index_select, _aten.gather}
# functional collectives (op name, after any "_coalesced" / "_out" / trailing "_") -> kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_NOT_COMMS = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads of input ``t``: its elements, but an expanded
    view (stride 0) reads its storage once."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _is_view(func) -> bool:
    """An op whose outputs alias an input without writing it: a view."""
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _writes_input(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)


def _group_ranks(group_name) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))


def _collective_kind(func):
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    for suffix in ("_coalesced", "_out", "_"):
        name = name.removesuffix(suffix)
    if name in _NOT_COMMS:
        return "none"
    if name not in _COLLECTIVE_KIND:
        raise NotImplementedError(f"the roofline counter has no rule for the collective {func}")
    return _COLLECTIVE_KIND[name]


class Counter(TorchDispatchMode):
    """Per-GPU FLOPs, bytes, collective bytes and the peak of live bytes of
    the ops run inside it (see the module docstring).  Enter it around a
    step; read ``flops``, ``bytes``, ``coll``, ``coll_links``, ``temp_peak``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll["count"] = 0
        self.coll_links: Dict[str, float] = {k: 0.0 for k in LINKS}
        self.kernels: Dict[str, Dict[str, float]] = {}  # name -> launches, flops, bytes charged
        self.live = 0
        self.temp_peak = 0
        self._storages = WeakIdKeyDictionary()  # storage -> bytes, the step's own

    def charge_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """Charge a kernel's own count for work that its meta branch does not
        run (called by the kernel's wrapper on the meta device)."""
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs, and dispatches its local ops and collectives back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's sharding propagation runs the global op on fake tensors: no GPU runs it
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            if kind != "none":
                nbytes = sum(_nbytes(t) for t in outs)
                group = kwargs.get("group_name", args[-1] if args and isinstance(args[-1], str) else None)
                link, _ = link_bw(_group_ranks(group))
                self.coll[kind] += nbytes
                self.coll["count"] += 1
                self.coll_links[link] += nbytes
            self._track(func, outs)
            return
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if _is_view(func) or packet in _NO_TRAFFIC:
            return
        if packet in _GATHERS:
            ins = [t for t in _tensors((args, kwargs)) if not t.is_floating_point()]
            self.bytes += sum(_read_bytes(t) for t in ins) + 2 * sum(_nbytes(t) for t in outs)
        else:
            self.bytes += sum(_read_bytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        self._track(func, outs)

    def _track(self, func, outs) -> None:
        """Count each storage that a non-view, non-in-place op creates until
        it is freed."""
        if _writes_input(func) or _is_view(func):
            return
        for t in outs:
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.temp_peak = max(self.temp_peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n


@dataclass
class RooflineTerms:
    flops: float  # per-GPU flops
    hbm_bytes: float  # per-GPU bytes accessed
    coll_bytes: float  # per-GPU collective bytes moved
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0  # 6*N*D (train) or 2*N_active*D (inference), global
    coll_links: Dict[str, float] = field(default_factory=dict)  # collective bytes by link ("nvlink", "network")

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / LINKS[link] for link, b in self.coll_links.items())

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def useful_flops_ratio(self, n_chips: int) -> float:
        """MODEL_FLOPS / (counted flops summed over GPUs): remat/redundancy waste."""
        total = self.flops * n_chips
        return self.model_flops / total if total > 0 else 0.0

    def roofline_fraction(self, n_chips: int) -> float:
        """Useful-FLOPs MFU bound implied by the dominant term."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        if t_step <= 0:
            return 0.0
        return self.model_flops / (n_chips * PEAK_FLOPS_BF16 * t_step)

    def as_dict(self, n_chips: int) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio(n_chips),
            "roofline_fraction": self.roofline_fraction(n_chips),
            "collectives": self.coll_breakdown,
        }


def terms_from_counter(c: Counter, model_flops: float) -> RooflineTerms:
    return RooflineTerms(
        flops=c.flops,
        hbm_bytes=c.bytes,
        coll_bytes=float(sum(v for k, v in c.coll.items() if k != "count")),
        coll_breakdown=dict(c.coll),
        model_flops=model_flops,
        coll_links=dict(c.coll_links),
    )


def model_flops_estimate(n_params_active: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for a forward (prefill/decode)."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens
