"""Gradient compression for bandwidth-bound data parallelism.

The port of ``repro/training/compression.py``.  Two schemes:

* ``topk``: per-leaf magnitude top-k sparsification with **error feedback**
  (the residual is carried to the next step). The compressed
  representation is (values, flat indices).  Deterministic: on data without
  ties it keeps the same entries as JAX's ``jax.lax.top_k``.
* ``int8``: symmetric per-tensor int8 quantization with stochastic rounding;
  4x fewer bytes on the wire, unbiased in expectation.  The rounding noise
  comes from a ``torch.Generator``, which draws other numbers than a
  ``jax.random`` key, so only ``stochastic=False`` matches JAX bit for bit.

``EFState`` keeps the JAX field name (``residual``), so it checkpoints under
the same keys.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import nn

PyTree = object


class EFState(NamedTuple):
    residual: PyTree  # same structure as grads


def ef_init(params: PyTree) -> EFState:
    return EFState(residual=nn.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


# -- top-k sparsification ------------------------------------------------------------


def topk_compress(x: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``frac`` fraction of entries by magnitude.

    Returns (values, flat_indices), largest magnitude first; k is fixed by
    the shape.
    """
    flat = x.reshape(-1).to(torch.float32)
    k = max(1, int(frac * flat.numel()))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros((int(torch.Size(shape).numel()),), dtype=torch.float32, device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


def topk_with_error_feedback(grads: PyTree, ef: EFState, frac: float) -> Tuple[PyTree, EFState, float]:
    """grads -> (sparse-reconstructed grads, new EF state, compression ratio)."""

    def per_leaf(g, r):
        acc = g.to(torch.float32) + r
        vals, idx = topk_compress(acc, frac)
        recon = topk_decompress(vals, idx, acc.shape)
        return recon, acc - recon

    recon, resid = nn.tree_map_n(per_leaf, 2, grads, ef.residual)
    return recon, EFState(residual=resid), frac


# -- int8 quantization ------------------------------------------------------------------


def int8_quantize(
    x: torch.Tensor, gen: torch.Generator = None, stochastic: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with stochastic rounding. Returns (q, scale).

    ``gen`` draws the rounding noise (on its own device) when ``stochastic``.
    """
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    y = x32 / scale
    if stochastic:
        noise = torch.rand(y.shape, generator=gen, device=gen.device if gen is not None else y.device) - 0.5
        q = torch.clamp(torch.round(y + noise.to(y.device)), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_roundtrip(grads: PyTree, gen: torch.Generator = None, stochastic: bool = True) -> PyTree:
    return nn.tree_map(lambda g: int8_dequantize(*int8_quantize(g, gen, stochastic)), grads)
