"""Helpers shared by the kernel wrappers: the gradient of a CUDA launch.

The JAX package makes every kernel trainable with ``jax.custom_vjp``, whose
backward is the VJP of the kernel's jnp oracle (``repro/kernels/*/ops.py``:
``_bwd``, ``_gather_bwd``, ``_segment_bwd``).  The port does the same with
one ``torch.autograd.Function`` per kernel: its forward launches the CUDA
kernel, its backward re-runs the plain PyTorch version (``ref.py``) on the
saved inputs, on the same device, and returns autograd's VJP of it.  No TPU
kernel had a backward kernel, so none has one here; ``linear_scan``'s
backward runs its own forward kernel again, backwards in time
(``rglru/ops.py``), in place of the plain VJP, a loop over T.  On the CPU the
wrappers run the plain version itself, with plain autograd.
"""

from __future__ import annotations

import torch


def check_untracked(what: str, *tensors: torch.Tensor, why: str = "") -> None:
    """Raise if a kernel launch would hand back a result autograd cannot see.

    A kernel writes its result into a fresh tensor through ``data_ptr()``;
    outside its ``autograd.Function`` (whose forward runs with grad mode off)
    that result has no ``grad_fn``, and a backward through it would give the
    inputs no gradient, silently.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: a CUDA launch outside its autograd.Function would drop the "
            f"gradient of an input that requires grad{why}"
        )


def oracle_vjp(ctx, plain, g: torch.Tensor, *tensors: torch.Tensor):
    """The VJP of ``plain(*tensors)`` against ``g``, one entry per tensor.

    Only the inputs ``ctx.needs_input_grad`` asks for are differentiated;
    the others get None.  The saved inputs are detached, so the plain
    version builds a graph of its own, which ends here.
    """
    needs = [bool(n) for n in ctx.needs_input_grad[: len(tensors)]]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs)]
        grads = iter(torch.autograd.grad(plain(*ins), [t for t, n in zip(ins, needs) if n], g))
    return tuple(next(grads) if n else None for n in needs)
