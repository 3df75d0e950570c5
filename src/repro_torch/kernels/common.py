"""Helpers shared by the kernel wrappers: the gradient of a CUDA launch, and
the zero-padding of ragged layer widths for the MLP kernels.

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
import torch.nn.functional as F


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


def round8(n: int) -> int:
    """``n`` rounded up to a multiple of 8, the MLP kernels' width unit."""
    return -(-int(n) // 8) * 8


def pad_widths(w1, b1, w2, b2, state: int = 0):
    """A 2-layer bank's weights with the hidden width H1 and the output width
    H2 zero-padded to multiples of 8, the widths the MMA tile takes.

    A zero column of W1 with a zero bias gives relu(0) = 0, and a zero row
    of W2 adds nothing, so the padded bank computes the same outputs in its
    first H2 columns and zeros in the rest.  With ``state = H`` the input is
    a stage-3 row ``[h, msg]`` of 2H columns (H2 == H) that the kernel builds
    from an ``H``-padded state, so W1's two halves move to rows ``[0, H)`` and
    ``[round8(H), round8(H) + H)``.
    """
    H1, H2 = w1.shape[-1], w2.shape[-1]
    P1, P2 = round8(H1), round8(H2)
    if state:
        w1p = w1.new_zeros((*w1.shape[:-2], 2 * P2, P1))
        w1p[..., :state, :H1] = w1[..., :state, :]
        w1p[..., P2 : P2 + state, :H1] = w1[..., state:, :]
    else:
        w1p = F.pad(w1, (0, P1 - H1))
    return w1p, F.pad(b1, (0, P1 - H1)), F.pad(w2, (0, P2 - H2, 0, P1 - H1)), F.pad(b2, (0, P2 - H2))
