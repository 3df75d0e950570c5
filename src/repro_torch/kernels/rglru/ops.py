"""Wrapper of the RG-LRU linear-scan kernel (``csrc/rglru.cu``).

For tensors on the CPU it runs the plain version (``ref.py``) under plain
autograd; for tensors on a GPU it launches the CUDA kernel or raises.  It
never falls back.  The kernel reads ``a``, ``b`` and ``h0`` through their
strides, so a non-contiguous input (``h0`` as a slice of a stacked cache, a
step slice of a wider tensor) needs no copy; the output is a new contiguous
tensor.

On the ``meta`` device (the dry run) it computes nothing and charges the
counting dispatch mode the kernel's own count (``_meta_launch``).

On a GPU the launch runs inside an ``autograd.Function``.  Its backward is
not the plain version's VJP (which the JAX package's ``custom_vjp`` uses, and
the COSTREAM kernels' Functions): the VJP of ``h_t = a_t h_{t-1} + b_t`` is
itself a linear scan, run backwards in time (``linear_scan_bwd``), so the
backward launches the same kernel once on reversed copies of its inputs.
The plain VJP is a sequential loop over T under autograd, hundreds of times
slower at a training shape; the tests hold the reversed scan against it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_untracked
from repro_torch.kernels.rglru.ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over T: a, b (B, T, D), h0 (B, D), all
    float32 on one device -> h (B, T, D) float32.  T = 0 gives an empty
    result and launches nothing.  Differentiable in ``a``, ``b`` and ``h0``."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"linear_scan takes float32 only; {name} is {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"linear_scan: {name} is on {t.device}, a on {a.device}")
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"linear_scan wants a and b (B, T, D) of one shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    B, T, D = a.shape
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"linear_scan wants h0 {(B, D)}; got {tuple(h0.shape)}")
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, h0)
    if a.device.type == "meta":
        return _MetaScan.apply(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on the CPU or a CUDA device, not {a.device}")
    return _LinearScan.apply(a, b, h0)


def _meta_launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on the ``meta`` device, shape propagation for the
    dry run (``launch/dryrun.py``): an empty result of ``a``'s shape, and
    nothing computed.  A DTensor input is first laid out as the kernel needs
    it, each rank holding whole sequences: a mesh dimension that shards T is
    replicated (DTensor gathers it), ``b`` takes ``a``'s placements and
    ``h0`` the matching ones on (B, D).  Every dispatch mode on the stack
    that counts kernels (``charge_kernel``, the roofline counter) is charged
    the kernel's own count on the local shapes: 2 B T D FLOPs, and
    4 (3 B T D + B D) bytes (``a``, ``b`` and ``h0`` read, ``h`` written)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    dt = next((t for t in (a, b, h0) if isinstance(t, DTensor)), None)
    if dt is not None:
        mesh = dt.device_mesh
        a, b, h0 = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
                    for t in (a, b, h0))
        pa = [Replicate() if p.is_shard(1) or not p.is_shard() else p for p in a.placements]
        ph = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate() for p in pa]
        a, b, h0 = a.redistribute(mesh, pa), b.redistribute(mesh, pa), h0.redistribute(mesh, ph)
        B, T, D = a.to_local().shape
    else:
        B, T, D = a.shape
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "charge_kernel"):
            mode.charge_kernel("linear_scan", 2.0 * B * T * D, 4.0 * (3 * B * T * D + B * D))
    return torch.empty_like(a)


def _launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    check_untracked("linear_scan", a, b, h0)
    B, T, D = a.shape
    out = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("linear_scan")
    err = launch(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), h0.data_ptr(), *h0.stride(), out.data_ptr(),
        B, T, D, a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check("linear_scan", err)
    obs.launch("linear_scan")
    return out




def linear_scan_bwd(
    a: torch.Tensor, h0: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
    scan: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of ``h = scan(a, b, h0)`` against ``g = dL/dh``: (da, db, dh0).

    With ``h_{-1} = h0`` the adjoint is ``lam_{T-1} = g_{T-1}`` and ``lam_t =
    g_t + a_{t+1} lam_{t+1}``; then ``db = lam``, ``da_t = lam_t h_{t-1}`` and
    ``dh0 = a_0 lam_0``.  ``lam`` is ``scan`` over reversed time with the
    coefficients shifted by one step and a zero start: one call of ``scan``
    (the kernel on the card, ``linear_scan_ref`` in the tests) on
    ``torch.flip`` copies.  ``h`` is the forward's output, saved, not
    recomputed.
    """
    B, T, D = a.shape
    if T == 0:
        return torch.zeros_like(a), torch.zeros_like(a), torch.zeros_like(h0)
    # reversed time: step s = T-1-t takes coefficient a_{t+1}; the first (a_T) meets the zero start
    a_rev = torch.cat([torch.zeros_like(a[:, :1]), torch.flip(a[:, 1:], [1])], dim=1)
    lam = torch.flip(scan(a_rev, torch.flip(g, [1]), torch.zeros_like(h0)), [1])
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    return lam * h_prev, lam, a[:, 0] * lam[:, 0]


class _MetaScan(torch.autograd.Function):
    """``_LinearScan`` on the ``meta`` device: the same backward, with
    ``_meta_launch`` for the kernel."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _meta_launch(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = linear_scan_bwd(a, h0, h, g.to(torch.float32), _meta_launch)
        return tuple(d if n else None for d, n in zip((da, db, dh0), ctx.needs_input_grad))


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = _launch(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = linear_scan_bwd(a, h0, h, g.to(torch.float32), _launch)
        return tuple(d if n else None for d, n in zip((da, db, dh0), ctx.needs_input_grad))
