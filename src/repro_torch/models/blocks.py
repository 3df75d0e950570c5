"""Transformer building blocks (port of ``repro/models/blocks.py``).

Every block has a ``*_defs(cfg)`` (a ``ParamDef`` tree with the JAX
package's key paths and sharding axes) and an ``apply_*`` function on
tensors.  Ported so far: RMSNorm, RoPE, softcap; self-attention (GQA/MQA,
qk-norm, softcaps, sliding window) uncached and into a decode cache, with
the naive and the blocked online-softmax paths; the SwiGLU / GeGLU / GELU
FFNs; the RG-LRU recurrent block (RecurrentGemma / Griffin), whose linear
recurrence runs the ``rglru`` kernel.  Cross-attention, MLA, MoE and the
xLSTM blocks are not ported yet (ROADMAP queue 1, item 10).

Dtypes follow the JAX package: matmuls in the activation dtype, norms,
attention softmax, RG-LRU gates and the recurrence in float32 where it casts
to float32.  JAX's GELU is the tanh approximation (``approximate="tanh"``
here); torch's ``softplus`` turns linear above 20, below float32 precision
there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rglru import ops as scan_ops
from repro_torch.kernels.rglru.ref import linear_scan_ref
from repro_torch.models.params import pdef

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int) -> Params:
    return {"scale": pdef((d,), (None,), init="zeros", dtype=torch.float32)}


def apply_rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"])).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    angle = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    window: Optional[int] = None  # sliding-window size; None = global
    causal: bool = True
    rope_theta: float = 10_000.0
    cross: bool = False  # cross-attention (kv from encoder output): not ported yet


def attn_defs(c: AttnConfig) -> Params:
    d, h, kv, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    p = {
        "wq": pdef((d, h * hd), ("embed", "heads"), granularity=(1, hd)),
        "wk": pdef((d, kv * hd), ("embed", "kv"), granularity=(1, hd)),
        "wv": pdef((d, kv * hd), ("embed", "kv"), granularity=(1, hd)),
        "wo": pdef((h * hd, d), ("heads", "embed"), granularity=(hd, 1)),
    }
    if c.qk_norm:
        p["q_norm"] = rmsnorm_defs(hd)
        p["k_norm"] = rmsnorm_defs(hd)
    return p


# k-sequence chunk length for blocked attention; naive path below this size.
ATTN_BLOCK = 1024


def _mask(qp, k_pos, causal, window, k_len):
    """(B or 1, Sq, Sk) bool: which keys each query may attend to."""
    mask = torch.ones((qp.shape[0], qp.shape[1], k_pos.shape[0]), dtype=torch.bool, device=qp.device)
    if causal:
        mask &= qp[:, :, None] >= k_pos[None, None, :]
    if window is not None:
        mask &= (qp[:, :, None] - k_pos[None, None, :]) < window
    if k_len is not None:
        mask &= k_pos[None, None, :] < k_len
    return mask


def _attend_naive(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    q_pos: torch.Tensor,  # (Sq,) or (B, Sq)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
    cap: Optional[float],
    k_len: Optional[int] = None,  # valid cache length for decode
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, D)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qh.to(torch.float32), k.to(torch.float32))
    logits = softcap(logits / math.sqrt(D), cap)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    mask = _mask(qp, k_pos, causal, window, k_len)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, D)


def _attend_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    window: Optional[int],
    cap: Optional[float],
    k_len: Optional[int] = None,
    block: int = ATTN_BLOCK,
) -> torch.Tensor:
    """Flash-style online-softmax attention over k-chunks of ``block`` keys:
    never materializes the (Sq, Sk) logits.  Padded keys sit at position
    ``2**30``, which every causal or length mask drops."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nblk = (Sk + block - 1) // block
    pad = nblk * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
    qh = (q.to(torch.float32) / math.sqrt(D)).reshape(B, Sq, KV, rep, D)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]

    m = torch.full((B, KV, rep, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, rep, Sq, D), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block, (i + 1) * block)
        kc, vc, pc = k[:, blk], v[:, blk], k_pos[blk]
        logits = softcap(torch.einsum("bqkrd,bskd->bkrqs", qh, kc.to(torch.float32)), cap)
        mask = _mask(qp, pc, causal, window, k_len)
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + torch.sum(p, dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkrqs,bskd->bkrqd", p, vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, rep, Sq, D)
    return torch.movedim(out, 3, 1).reshape(B, Sq, H, D)


def _attend(q, k, v, **kw):
    if k.shape[1] > ATTN_BLOCK:
        if torch.is_grad_enabled():
            # as the JAX package's jax.checkpoint: the backward recomputes each
            # chunk's fp32 probabilities instead of keeping all of them
            return checkpoint(lambda q, k, v: _attend_blocked(q, k, v, **kw), q, k, v, use_reentrant=False)
        return _attend_blocked(q, k, v, **kw)
    return _attend_naive(q, k, v, **kw)


def apply_attn(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: AttnConfig,
    *,
    positions: torch.Tensor,  # (S,) int absolute positions of x
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"} (B, S_max, KV, D)
    cache_len: Optional[int] = None,  # tokens already cached
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention, uncached or into a decode cache (prefill: ``cache_len``
    0 and S prompt tokens; decode: S = 1).  The cache is not written in
    place: the new one is returned.  JAX's ``dynamic_update_slice`` clamps
    a write that would run past the cache; this raises instead."""
    if c.cross:
        raise NotImplementedError("cross-attention is not ported yet (ROADMAP queue 1, item 10)")
    B, S, _ = x.shape
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if c.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q)
        k = apply_rmsnorm(p["k_norm"], k)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)

    new_cache = None
    kw = dict(q_pos=positions, causal=c.causal, window=c.window, cap=c.attn_softcap)
    if cache is not None:
        max_seq = cache["k"].shape[1]
        if not 0 <= cache_len <= max_seq - S:
            raise ValueError(f"apply_attn: writing {S} tokens at {cache_len} overruns a cache of {max_seq}")
        k_all, v_all = cache["k"].clone(), cache["v"].clone()
        k_all[:, cache_len : cache_len + S] = k.to(k_all.dtype)
        v_all[:, cache_len : cache_len + S] = v.to(v_all.dtype)
        new_cache = {"k": k_all, "v": v_all}
        k_pos = torch.arange(max_seq, dtype=torch.int32, device=x.device)
        out = _attend(q, k_all, v_all, k_pos=k_pos, k_len=cache_len + S, **kw)
    else:
        k_pos = positions if positions.ndim == 1 else positions[0]
        out = _attend(q, k, v, k_pos=k_pos, **kw)
    y = out.reshape(B, S, h * hd).to(x.dtype) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_defs(d: int, f: int, kind: str) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": pdef((d, f), ("embed", "ff")),
            "w_up": pdef((d, f), ("embed", "ff")),
            "w_down": pdef((f, d), ("ff", "embed")),
        }
    return {
        "w_in": pdef((d, f), ("embed", "ff")),
        "b_in": pdef((f,), ("ff",), init="zeros"),
        "w_out": pdef((f, d), ("ff", "embed")),
        "b_out": pdef((d,), (None,), init="zeros"),
    }


def apply_ffn(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh") @ p["w_out"] + p["b_out"]


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    width: int  # recurrence width (channels)
    conv_width: int = 4
    c_const: float = 8.0
    use_kernel: bool = True  # the rglru linear-scan kernel; False: its plain version
    block_diag_gates: bool = False  # Griffin's block-diagonal gate matrices
    n_gate_blocks: int = 1


def rglru_defs(c: RGLRUConfig) -> Params:
    d, r = c.d_model, c.width
    p = {
        "w_x": pdef((d, r), ("embed", "ff")),
        "w_gate": pdef((d, r), ("embed", "ff")),
        "conv_k": pdef((c.conv_width, r), (None, "ff"), scale=0.5),
        "conv_b": pdef((r,), ("ff",), init="zeros"),
        "b_rg": pdef((r,), ("ff",), init="zeros"),
        "b_ig": pdef((r,), ("ff",), init="zeros"),
        "lam": pdef((r,), ("ff",), init="normal", scale=1.0, dtype=torch.float32),
        "w_out": pdef((r, d), ("ff", "embed")),
    }
    if c.block_diag_gates:
        nb = c.n_gate_blocks
        rb = r // nb
        p["w_rg"] = pdef((nb, rb, rb), ("ff", None, None), scale=0.5)
        p["w_ig"] = pdef((nb, rb, rb), ("ff", None, None), scale=0.5)
    else:
        p["w_rg"] = pdef((r, r), ("ff", None), scale=0.5)  # recurrence gate
        p["w_ig"] = pdef((r, r), ("ff", None), scale=0.5)  # input gate
    return p


def _gate_matmul(u: torch.Tensor, w: torch.Tensor, c: RGLRUConfig) -> torch.Tensor:
    if not c.block_diag_gates:
        return u @ w
    nb = c.n_gate_blocks
    B, S, r = u.shape
    return torch.einsum("bsnr,nre->bsne", u.reshape(B, S, nb, r // nb), w).reshape(B, S, r)


def _causal_conv1d(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, state: Optional[torch.Tensor] = None):
    """x: (B, S, r); k: (W, r) depthwise. state: (B, W-1, r) trailing inputs."""
    W = k.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, r)
    out = sum(xp[:, i : i + x.shape[1], :] * k[i] for i in range(W)) + b
    new_state = xp[:, -(W - 1) :, :]
    return out.to(x.dtype), new_state


def apply_rglru(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: RGLRUConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"h": (B, r), "conv": (B, W-1, r)}
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")  # (B, S, r)
    u = x @ p["w_x"]
    u, conv_state = _causal_conv1d(u, p["conv_k"], p["conv_b"], cache["conv"] if cache is not None else None)

    r_gate = torch.sigmoid(_gate_matmul(u, p["w_rg"], c) + p["b_rg"]).to(torch.float32)
    i_gate = torch.sigmoid(_gate_matmul(u, p["w_ig"], c) + p["b_ig"]).to(torch.float32)
    log_a = -c.c_const * F.softplus(p["lam"]) * r_gate  # (B, S, r) in fp32
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i_gate * u.to(torch.float32))

    if cache is not None:
        h0 = cache["h"].to(torch.float32)
    else:
        h0 = torch.zeros((x.shape[0], c.width), dtype=torch.float32, device=x.device)
    h = (scan_ops.linear_scan if c.use_kernel else linear_scan_ref)(a, gated_in, h0)

    y = (h.to(x.dtype) * gate) @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {"h": h[:, -1, :].to(cache["h"].dtype), "conv": conv_state}
    return y, new_cache
