"""Transformer building blocks (port of ``repro/models/blocks.py``).

Every block has a ``*_defs(cfg)`` (a ``ParamDef`` tree with the JAX
package's key paths and sharding axes) and an ``apply_*`` function on
tensors: RMSNorm, RoPE, softcap; self-attention (GQA/MQA, qk-norm,
softcaps, sliding window, bidirectional for the whisper encoder) uncached
and into a decode cache, with the naive and the blocked online-softmax
paths; cross-attention over an encoder's output or its cached keys and
values (whisper); MLA with its compressed KV cache
(deepseek-v2); the SwiGLU / GeGLU / GELU FFNs; the top-k MoE with per-sequence
capacity, shared experts and a dense residual branch (arctic, deepseek-v2);
the RG-LRU recurrent block (RecurrentGemma / Griffin), whose linear
recurrence runs the ``rglru`` kernel; the mLSTM and sLSTM blocks (xLSTM).

Dtypes follow the JAX package: matmuls in the activation dtype, norms,
attention softmax, the MoE router's softmax and combine, RG-LRU gates and
the recurrences in float32 where it casts to float32.  JAX's GELU is the
tanh approximation (``approximate="tanh"`` here); torch's ``softplus`` turns
linear above 20, below float32 precision there.
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
from repro_torch.models.sharding_ctx import batch_only, constrain_heads, einsum, like, merge, unflatten

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
    cross: bool = False  # cross-attention (kv from encoder output)


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
    qh = unflatten(q, 2, (KV, H // KV))
    logits = einsum("bqkrd,bskd->bkrqs", qh.to(torch.float32), k.to(torch.float32))
    logits = softcap(logits / math.sqrt(D), cap)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    mask = _mask(qp, k_pos, causal, window, k_len)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = einsum("bkrqs,bskd->bqkrd", probs, v.to(torch.float32))
    return merge(out, 2)


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
    never materializes the (Sq, Sk) logits.  Sk is zero-padded to a multiple
    of ``block``, the padded keys at position ``2**30``: a causal or a length
    mask drops them, but with neither (the whisper encoder, cross-attention)
    they stay in the softmax, each a logit of 0 over a zero value, as in the
    JAX package's ``_attend_blocked``.  So there this path differs from the
    naive one (1,500 keys carry 548 padded ones)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nblk = (Sk + block - 1) // block
    pad = nblk * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
    qh = unflatten(q.to(torch.float32) / math.sqrt(D), 2, (KV, rep))
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]

    m = torch.full((B, KV, rep, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, rep, Sq, D), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block, (i + 1) * block)
        kc, vc, pc = k[:, blk], v[:, blk], k_pos[blk]
        logits = softcap(einsum("bqkrd,bskd->bkrqs", qh, kc.to(torch.float32)), cap)
        mask = _mask(qp, pc, causal, window, k_len)
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + torch.sum(p, dim=-1)
        acc = acc * scale[..., None] + einsum("bkrqs,bskd->bkrqd", p, vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, rep, Sq, D)
    return merge(torch.movedim(out, 3, 1), 2)


def _attend(q, k, v, **kw):
    q, k, v = (constrain_heads(t, k.shape[2]) for t in (q, k, v))
    if k.shape[1] > ATTN_BLOCK:
        if torch.is_grad_enabled():
            # as the JAX package's jax.checkpoint: the backward recomputes each
            # chunk's fp32 probabilities instead of keeping all of them
            return checkpoint(lambda q, k, v: _attend_blocked(q, k, v, **kw), q, k, v, use_reentrant=False)
        return _attend_blocked(q, k, v, **kw)
    return _attend_naive(q, k, v, **kw)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, start: int, who: str) -> torch.Tensor:
    """A copy of the cache ``buf`` (B, S_max, ...) with ``new`` (B, S, ...)
    written at sequence positions ``start .. start + S - 1``.  JAX's
    ``dynamic_update_slice`` clamps a write that would run past the cache;
    this raises instead."""
    max_seq, S = buf.shape[1], new.shape[1]
    if not 0 <= start <= max_seq - S:
        raise ValueError(f"{who}: writing {S} tokens at {start} overruns a cache of {max_seq}")
    out = buf.clone()
    out[:, start : start + S] = new.to(out.dtype)
    return out


def apply_attn(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: AttnConfig,
    *,
    positions: torch.Tensor,  # (S,) int absolute positions of x
    kv_source: Optional[torch.Tensor] = None,  # (B, S_enc, d) cross-attention source
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"} (B, S_max, KV, D)
    cache_len: Optional[int] = None,  # tokens already cached
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention, uncached or into a decode cache (prefill: ``cache_len``
    0 and S prompt tokens; decode: S = 1).  The cache is not written in
    place: the new one is returned (``_cache_write``).

    Cross-attention (``c.cross``) takes its keys and values from
    ``kv_source`` uncached, or reads the cached encoder keys and values
    (``cross_kv``) over all their rows, with no length mask, and returns the
    cache unchanged.  It applies no RoPE and no causal mask."""
    B, S, _ = x.shape
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    q = unflatten(x @ p["wq"], -1, (h, hd))
    k = v = None
    if not (c.cross and cache is not None):  # a cached cross-attention reads the encoder's kv
        src = kv_source if c.cross else x
        if src is None:
            raise ValueError("apply_attn: an uncached cross-attention needs kv_source")
        k = unflatten(src @ p["wk"], -1, (kv, hd))
        v = unflatten(src @ p["wv"], -1, (kv, hd))
    if c.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q)
        if k is not None:
            k = apply_rmsnorm(p["k_norm"], k)
    if not c.cross:
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)

    new_cache = None
    kw = dict(q_pos=positions, cap=c.attn_softcap)
    if cache is not None and not c.cross:
        k_all = _cache_write(cache["k"], k, cache_len, "apply_attn")
        v_all = _cache_write(cache["v"], v, cache_len, "apply_attn")
        new_cache = {"k": k_all, "v": v_all}
        k_pos = torch.arange(k_all.shape[1], dtype=torch.int32, device=x.device)
        out = _attend(q, k_all, v_all, k_pos=k_pos, causal=c.causal, window=c.window, k_len=cache_len + S, **kw)
    elif cache is not None:
        k_pos = torch.arange(cache["k"].shape[1], dtype=torch.int32, device=x.device)
        out = _attend(q, cache["k"], cache["v"], k_pos=k_pos, causal=False, window=None, **kw)
        new_cache = cache
    else:
        if c.cross:
            k_pos = torch.arange(src.shape[1], dtype=torch.int32, device=x.device)
        else:
            k_pos = positions if positions.ndim == 1 else positions[0]
        out = _attend(q, k, v, k_pos=k_pos, causal=c.causal and not c.cross, window=c.window, **kw)
    y = merge(out, 2).to(x.dtype) @ p["wo"]
    return y, new_cache


def cross_kv(p: Params, enc_out: torch.Tensor, c: AttnConfig) -> Dict[str, torch.Tensor]:
    """The cross-attention keys and values of an encoder output (B, S_enc, d),
    computed once for a decode cache: ``{"k", "v"}`` (B, S_enc, KV, D)."""
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (deepseek-v2 multi-head latent attention)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10_000.0


def mla_defs(c: MLAConfig) -> Params:
    h = c.n_heads
    return {
        "wq_a": pdef((c.d_model, c.q_lora), ("embed", None)),
        "q_norm": rmsnorm_defs(c.q_lora),
        "wq_b": pdef(
            (c.q_lora, h * (c.d_nope + c.d_rope)), (None, "heads"),
            granularity=(1, c.d_nope + c.d_rope),
        ),
        "wkv_a": pdef((c.d_model, c.kv_lora + c.d_rope), ("embed", None)),
        "kv_norm": rmsnorm_defs(c.kv_lora),
        "wk_b": pdef((c.kv_lora, h * c.d_nope), (None, "heads"), granularity=(1, c.d_nope)),
        "wv_b": pdef((c.kv_lora, h * c.d_v), (None, "heads"), granularity=(1, c.d_v)),
        "wo": pdef((h * c.d_v, c.d_model), ("heads", "embed"), granularity=(c.d_v, 1)),
    }


def apply_mla(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: MLAConfig,
    *,
    positions: torch.Tensor,  # (S,) int absolute positions of x
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"ckv": (B, S_max, kv_lora + d_rope)}
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head latent attention.  Only the normalized compressed KV and the
    roped key part, packed as ``ckv``, are cached; each call expands the
    whole cache into per-head keys and values.  RoPE touches only the
    ``d_rope`` slices, the roped key is shared by every head, and the
    softmax scale is 1 / sqrt(d_nope + d_rope): ``v`` is zero-padded to that
    width for ``_attend`` and the output sliced back to ``d_v``."""
    B, S, _ = x.shape
    h, dq = c.n_heads, c.d_nope + c.d_rope
    q = unflatten(apply_rmsnorm(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"], -1, (h, dq))
    q = torch.cat([q[..., : c.d_nope], rope(q[..., c.d_nope :], positions, c.rope_theta)], dim=-1)

    ckv_full = x @ p["wkv_a"]  # (B, S, kv_lora + d_rope)
    ckv = apply_rmsnorm(p["kv_norm"], ckv_full[..., : c.kv_lora])
    k_rope = rope(ckv_full[:, :, None, c.kv_lora :], positions, c.rope_theta)[:, :, 0, :]
    packed = torch.cat([ckv, k_rope], dim=-1)

    new_cache, k_len = None, None
    if cache is not None:
        packed = _cache_write(cache["ckv"], packed, cache_len, "apply_mla")
        new_cache = {"ckv": packed}
        k_len = cache_len + S

    Sk = packed.shape[1]
    # every position's latent, whole on each rank (a cache sharded over its
    # sequence is gathered: the expansion below flattens batch and sequence)
    whole = batch_only(packed)
    ckv_all, k_rope_all = whole[..., : c.kv_lora], whole[..., c.kv_lora :]
    k_nope = unflatten(ckv_all @ p["wk_b"], -1, (h, c.d_nope))
    v = unflatten(ckv_all @ p["wv_b"], -1, (h, c.d_v))
    k = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(B, Sk, h, c.d_rope)], dim=-1)
    v = torch.cat([v, v.new_zeros((*v.shape[:-1], dq - c.d_v))], dim=-1)  # zero-padded to the q / k width
    out = _attend(q, k, v, q_pos=positions,
                  k_pos=torch.arange(Sk, dtype=torch.int32, device=x.device),
                  causal=True, window=None, cap=None, k_len=k_len)[..., : c.d_v]
    y = out.reshape(B, S, h * c.d_v).to(x.dtype) @ p["wo"]
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
# MoE
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0  # shared experts (deepseek-v2)
    shared_ff: int = 0
    dense_residual: bool = False  # parallel dense FFN branch (arctic)
    dense_ff: int = 0
    capacity_factor: float = 1.25


def moe_defs(d: int, c: MoEConfig, ffn_kind: str = "swiglu") -> Params:
    p: Params = {
        "router": pdef((d, c.n_experts), ("embed", None), scale=0.1),
        "w_gate": pdef((c.n_experts, d, c.expert_ff), ("experts", "embed", "ff")),
        "w_up": pdef((c.n_experts, d, c.expert_ff), ("experts", "embed", "ff")),
        "w_down": pdef((c.n_experts, c.expert_ff, d), ("experts", "ff", "embed")),
    }
    if c.n_shared > 0:
        p["shared"] = ffn_defs(d, c.shared_ff or c.expert_ff * c.n_shared, ffn_kind)
    if c.dense_residual:
        p["dense"] = ffn_defs(d, c.dense_ff or c.expert_ff, ffn_kind)
    return p


def moe_route(p: Params, x: torch.Tensor, c: MoEConfig):
    """The router of ``apply_moe``: ``(top_p, top_e, pos, cap)``.

    ``top_p`` (B, S, k) float32 is the softmax over the experts of ``x @
    router`` (the product in the activation dtype, then float32),
    renormalized over the k chosen experts ``top_e`` (the k largest, the
    lower index first among equals, as ``jax.lax.top_k``).  Each sequence
    is a dispatch group with ``cap`` = max(k, int(capacity_factor k S / E))
    places an expert; ``pos`` is each (token, slot) pair's place in its
    expert's buffer, counted token-major and then by slot (the JAX package's
    cumsum over the flattened (S k) axis).  A pair at ``pos >= cap`` is
    dropped.  So a decode step (S = 1) drops nothing, and a prefill may."""
    B, S, _ = x.shape
    E, k = c.n_experts, c.top_k
    probs = torch.softmax((x @ p["router"]).to(torch.float32), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat = top_e.reshape(B, S * k)
    pos = torch.cumsum(F.one_hot(flat, E), dim=1).gather(-1, flat[..., None])[..., 0] - 1
    return top_p, top_e, pos.reshape(B, S, k), max(k, int(c.capacity_factor * k * S / E))


def apply_moe(p: Params, x: torch.Tensor, c: MoEConfig, ffn_kind: str = "swiglu") -> torch.Tensor:
    """Top-k MoE with per-sequence capacity (``moe_route``), dispatched by
    index: the kept pairs' rows of ``x`` are gathered, exactly, into a
    (B, E, cap, d) buffer, the experts run as batched matmuls in the
    activation dtype, and each token sums its kept pairs' expert outputs
    weighted by ``top_p`` in float32, then casts.  The same numbers as the
    JAX package's one-hot einsums, without their (B, S, k, E, cap)
    tensors.  Shared experts and the dense branch add a plain FFN of ``x``."""
    B, S, d = x.shape
    E, k = c.n_experts, c.top_k
    top_p, top_e, pos, cap = moe_route(p, x, c)
    keep = pos < cap
    # each pair's row in the (B, E cap + 1) buffer; dropped pairs go to the spare last row
    slot = torch.where(keep, top_e * cap + pos, E * cap).reshape(B, S * k)
    pair_token = torch.arange(S, device=x.device).repeat_interleave(k).expand(B, -1)
    # the token each buffer row holds; S (a zero row) where no pair fills it
    row_token = torch.full((B, E * cap + 1), S, dtype=torch.int64, device=x.device).scatter(1, slot, pair_token)
    xz = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)
    xe = torch.gather(xz, 1, row_token[:, : E * cap, None].expand(-1, -1, d))  # (B, E cap, d)
    xe = xe.reshape(B, E, cap, d).transpose(0, 1).reshape(E, B * cap, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E, B, cap, d).transpose(0, 1).reshape(B, E * cap, d)
    ye = torch.cat([ye, ye.new_zeros(B, 1, d)], dim=1)  # the spare row: dropped pairs add 0
    picked = torch.gather(ye, 1, slot[..., None].expand(-1, -1, d)).to(torch.float32).reshape(B, S, k, d)
    y = torch.sum(picked * (top_p * keep)[..., None], dim=2).to(x.dtype)
    if c.n_shared > 0:
        y = y + apply_ffn(p["shared"], x, ffn_kind)
    if c.dense_residual:
        y = y + apply_ffn(p["dense"], x, ffn_kind)
    return y


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
    return torch.einsum("bsnr,nre->bsne", unflatten(u, -1, (nb, r // nb)), w).reshape(B, S, r)


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

    # each gate laid out as u (on a mesh: its partial sums over the channels reduced)
    r_gate = torch.sigmoid(like(_gate_matmul(u, p["w_rg"], c), u) + p["b_rg"]).to(torch.float32)
    i_gate = torch.sigmoid(like(_gate_matmul(u, p["w_ig"], c), u) + p["b_ig"]).to(torch.float32)
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


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    expansion: int = 2  # mLSTM up-projection factor
    chunk: int = 64  # the JAX package's chunk length; neither package's blocks read it


def mlstm_defs(c: XLSTMConfig) -> Params:
    d = c.d_model
    di = c.expansion * d
    return {
        "w_up": pdef((d, 2 * di), ("embed", "ff")),
        "wq": pdef((di, di), ("ff", None)),
        "wk": pdef((di, di), ("ff", None)),
        "wv": pdef((di, di), ("ff", None)),
        "w_if": pdef((di, 2 * c.n_heads), ("ff", None), scale=0.1),  # i/f gate logits
        "b_if": pdef((2 * c.n_heads,), (None,), init="zeros"),
        "norm": rmsnorm_defs(di),
        "w_down": pdef((di, d), ("ff", "embed")),
    }


def apply_mlstm(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: XLSTMConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """mLSTM: a matrix memory per head with exponential input and sigmoid
    forget gates, run as a time loop (JAX's ``lax.scan``) on float32 state.
    Uncached, the stabilizer ``m`` starts at -1e30; a cache carries its own
    (zeros in a fresh one, as in the JAX package, so a prefill into a fresh
    cache is not the uncached forward).  The outer product v k^T is in the
    activation dtype, the denominator max(|n . q|, 1)."""
    B, S, d = x.shape
    di = c.expansion * d
    H = c.n_heads
    dh = di // H
    up = x @ p["w_up"]
    u, z = up[..., :di], up[..., di:]
    # the time loop's inputs whole in time on each rank (``batch_only``: a mesh may shard the sequence)
    q = batch_only(unflatten(u @ p["wq"], -1, (H, dh)))
    k = batch_only(unflatten(u @ p["wk"], -1, (H, dh))) / math.sqrt(dh)
    v = batch_only(unflatten(u @ p["wv"], -1, (H, dh)))
    gates = batch_only((u @ p["w_if"] + p["b_if"]).to(torch.float32))  # (B, S, 2H)
    log_i = gates[..., :H]  # exponential input gate (log space)
    log_f = F.logsigmoid(gates[..., H:])  # forget gate

    if cache is not None:
        C, n, m = (cache[key].to(torch.float32) for key in ("C", "n", "m"))
    else:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    # the loop runs on (B, H, 1, 1) gates and stabilizer, (B, H, 1, dh) k and
    # n, (B, H, dh, 1) v and q, so that its body indexes nothing
    n, m = n[:, :, None, :], m[..., None, None]
    q32 = q.to(torch.float32)
    nums, ns = [], []
    for li, lf, kt, vt, qt in zip(log_i[..., None, None].unbind(1), log_f[..., None, None].unbind(1),
                                  k[:, :, :, None, :].unbind(1), v[..., None].unbind(1), q32[..., None].unbind(1)):
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(li - m_new)
        C = fg * C + ig * (vt * kt)  # the outer product v k^T in the activation dtype
        n = fg * n + ig * kt
        nums.append(C @ qt)
        ns.append(n)
        m = m_new
    num = torch.stack(nums, dim=1)[..., 0]  # (B, S, H, dh)
    den = torch.clamp(torch.abs(torch.sum(torch.stack(ns, dim=1)[:, :, :, 0, :] * q32, dim=-1)), min=1.0)
    h = merge((num / den[..., None]).to(x.dtype), 2)  # (B, S, di)
    n, m = n[:, :, 0, :], m[..., 0, 0]
    h = apply_rmsnorm(p["norm"], h) * F.silu(z)
    y = h @ p["w_down"]
    new_cache = None
    if cache is not None:
        new_cache = {"C": C.to(cache["C"].dtype), "n": n.to(cache["n"].dtype), "m": m.to(cache["m"].dtype)}
    return y, new_cache


def slstm_defs(c: XLSTMConfig) -> Params:
    d = c.d_model
    H = c.n_heads
    dh = d // H
    return {
        "w_gates": pdef((d, 4 * d), ("embed", "ff")),  # i, f, z, o pre-activations
        "b_gates": pdef((4 * d,), (None,), init="zeros"),
        "r_gates": pdef((H, dh, 4 * dh), (None, None, None), scale=0.5),  # block-diag recurrent
        "norm": rmsnorm_defs(d),
        "w_out": pdef((d, d), ("embed", None)),
    }


def apply_slstm(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    c: XLSTMConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"c", "n", "m", "h"}: (B, d) each
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """sLSTM: scalar memory with block-diagonal (per-head) recurrent gate
    weights, run as a time loop on float32 state; the recurrent product is
    in the activation dtype.  ``m`` starts as in ``apply_mlstm``."""
    B, S, d = x.shape
    H = c.n_heads
    dh = d // H
    pre = batch_only(x @ p["w_gates"] + p["b_gates"])  # (B, S, 4d), whole in time on each rank
    if cache is not None:
        cst, nst, mst, hst = (cache[key].to(torch.float32) for key in ("c", "n", "m", "h"))
    else:
        cst = nst = hst = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        mst = torch.full((B, d), -1e30, dtype=torch.float32, device=x.device)
    hs = []
    for pre_t in pre.unbind(1):
        # per head (B, dh) @ (dh, 4 dh), laid out as the JAX package's einsum "bhd,hde->bhe"
        rec = torch.bmm(unflatten(hst, 1, (H, dh)).transpose(0, 1).to(x.dtype), p["r_gates"]).transpose(0, 1)
        gi, gf, gz, go = torch.chunk((pre_t + merge(rec, 1)).to(torch.float32), 4, dim=-1)
        lf = F.logsigmoid(gf) + mst
        m_new = torch.maximum(lf, gi)
        ig = torch.exp(gi - m_new)
        fg = torch.exp(lf - m_new)
        cst = fg * cst + ig * torch.tanh(gz)
        nst = fg * nst + ig
        hst = torch.sigmoid(go) * cst / torch.clamp(nst, min=1.0)
        mst = m_new
        hs.append(hst)
    h = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, d)
    y = apply_rmsnorm(p["norm"], h) @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {key: t.to(cache[key].dtype) for key, t in zip(("c", "n", "m", "h"), (cst, nst, mst, hst))}
    return y, new_cache
