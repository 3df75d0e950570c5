"""Transformer assembly for the ten architectures (port of ``repro/models/transformer.py``).

A model is a prefix + a repeated group pattern + a suffix of *blocks*.  The
group parameters (and caches) are stacked along a leading ``layers`` axis, as
in the JAX package, and run as a Python loop over the group index on the
stacked tensors: the loop stands for both of JAX's ``scan_layers`` branches.
Under autograd the uncached forward rematerializes each group by
``cfg.remat``, as JAX's scanned branch does (its unscanned one never
remats): ``"none"`` keeps every activation, ``"full"`` checkpoints the group
(``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the unbatched
matmuls (``aten.mm``, JAX's ``checkpoint_dots_with_no_batch_dims``) and
recomputes the rest.  Block kinds:

  "attn"     global attention + FFN           (internlm2, qwen3, deepseek-67b,
                                               internvl2 backbone)
  "local"    sliding-window attention + FFN   (recurrentgemma, gemma2)
  "global"   global attention + FFN, gemma2 sandwich norms by name
  "moe"      global attention + MoE           (arctic: + dense residual)
  "mla"      MLA attention + dense FFN        (deepseek-v2 first layer)
  "mla_moe"  MLA attention + MoE              (deepseek-v2)
  "rec"      RG-LRU recurrent block + FFN     (recurrentgemma)
  "mlstm"/"slstm"  xLSTM blocks, mixer only (no FFN half; d_ff = 0)
  "enc"      bidirectional attention + FFN    (whisper encoder)
  "dec"      causal self-attn + cross-attn + FFN (whisper decoder)

The frontends are stubs, as in the JAX package: a vision model takes
precomputed patch embeddings (``vis_embeds``, a prefix before the tokens),
an audio model precomputed frame embeddings (``frames``, the encoder's
input).  An encoder-decoder adds sinusoidal positions to the encoder's
frames and to the decoder's tokens and applies RoPE in every
self-attention as well: the JAX package's whisper backbone.  Activations
are pinned where the JAX package pins them (``sharding_ctx.constrain_batch``
after the embedding and each group, the vocab-parallel logits); without an
installed mesh those are the identity.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import nn
from repro_torch.models import blocks as B
from repro_torch.models.params import ParamDef, mesh_shape, pdef
from repro_torch.models.sharding_ctx import batch_only, constrain, constrain_batch, get_mesh

Params = Dict[str, Any]

# the decode cache's cross-attention rows: whisper's native encoder frames
ENC_LEN = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer structure
    prefix: Tuple[str, ...] = ()
    pattern: Tuple[str, ...] = ("attn",)
    n_groups: int = 1
    suffix: Tuple[str, ...] = ()
    # attention details
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None
    rope_theta: float = 10_000.0
    # families
    mla: Optional[B.MLAConfig] = None
    moe: Optional[B.MoEConfig] = None
    rnn_width: Optional[int] = None
    conv_width: int = 4
    xlstm: Optional[B.XLSTMConfig] = None
    # ffn / embeddings
    ffn_kind: str = "swiglu"
    tie_embeddings: bool = False
    emb_scale: bool = False
    norm_eps: float = 1e-6
    # enc-dec (whisper): encoder stack runs first; None = decoder-only
    enc_pattern: Optional[Tuple[str, ...]] = None
    enc_groups: int = 0
    enc_positions: str = "rope"  # rope | sinusoidal
    # modality frontend stub
    frontend: str = "none"  # none | vision | audio
    vis_len: int = 0  # visual prefix length (vlm)
    # rematerialization of each layer group under autograd: none | full | dots
    remat: str = "full"
    # run the rglru linear-scan kernel inside RG-LRU blocks
    use_rglru_kernel: bool = False
    # Griffin-style block-diagonal RG-LRU gate matrices
    rg_blockdiag: bool = False
    scan_layers: bool = True

    def n_layers(self) -> int:
        return (
            len(self.prefix)
            + self.n_groups * len(self.pattern)
            + len(self.suffix)
            + self.enc_groups * len(self.enc_pattern or ())
        )

    def attn_cfg(self, kind: str) -> B.AttnConfig:
        return B.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            qk_norm=self.qk_norm,
            attn_softcap=self.attn_softcap,
            window=self.window if kind == "local" else None,
            causal=kind != "enc",
            rope_theta=self.rope_theta,
            cross=False,
        )

    def cross_cfg(self) -> B.AttnConfig:
        return dataclasses.replace(self.attn_cfg("dec"), cross=True, causal=False)

    def rglru_cfg(self) -> B.RGLRUConfig:
        return B.RGLRUConfig(
            d_model=self.d_model,
            width=self.rnn_width or self.d_model,
            conv_width=self.conv_width,
            use_kernel=self.use_rglru_kernel,
            block_diag_gates=self.rg_blockdiag,
            n_gate_blocks=self.n_heads if self.rg_blockdiag else 1,
        )


# ---------------------------------------------------------------------------
# block definitions
# ---------------------------------------------------------------------------

_SANDWICH = ("global", "local")  # gemma2-style pre+post norms


def block_defs(cfg: ModelConfig, kind: str) -> Params:
    d = cfg.d_model
    p: Params = {"norm1": B.rmsnorm_defs(d)}
    if kind in ("attn", "local", "global", "moe", "enc", "dec"):
        p["attn"] = B.attn_defs(cfg.attn_cfg(kind))
    elif kind in ("mla", "mla_moe"):
        p["attn"] = B.mla_defs(cfg.mla)
    elif kind == "rec":
        p["rec"] = B.rglru_defs(cfg.rglru_cfg())
    elif kind == "mlstm":
        p["mix"] = B.mlstm_defs(cfg.xlstm)
        return p  # xLSTM blocks: mixer only
    elif kind == "slstm":
        p["mix"] = B.slstm_defs(cfg.xlstm)
        return p
    else:
        raise ValueError(f"block kind {kind!r}")
    if kind == "dec":
        p["norm_c"] = B.rmsnorm_defs(d)
        p["cross"] = B.attn_defs(cfg.cross_cfg())
    p["norm2"] = B.rmsnorm_defs(d)
    if kind in ("moe", "mla_moe"):
        p["moe"] = B.moe_defs(d, cfg.moe, cfg.ffn_kind)
    else:
        p["ffn"] = B.ffn_defs(d, cfg.d_ff, cfg.ffn_kind)
    if kind in _SANDWICH and cfg.name.startswith("gemma2"):
        p["post_norm1"] = B.rmsnorm_defs(d)
        p["post_norm2"] = B.rmsnorm_defs(d)
    return p


def cache_defs(cfg: ModelConfig, kind: str, batch: int, max_seq: int) -> Params:
    """Decode-cache ParamDefs for one block (shapes + sharding axes).  A
    local-attention cache is a full ``max_seq`` buffer, as in the JAX package;
    a decoder block's also holds the cross-attention keys and values ``xk`` /
    ``xv`` at ``ENC_LEN`` rows, whatever the number of frames (``cross_kv``
    fills them; fewer frames leave zero rows that are attended)."""
    shp = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    ax = ("batch", "act_seq", "kv", None)
    if kind in ("attn", "global", "local", "moe", "enc"):
        return {"k": pdef(shp, ax, init="zeros"), "v": pdef(shp, ax, init="zeros")}
    if kind == "dec":
        xshp = (batch, ENC_LEN, cfg.n_kv_heads, cfg.head_dim)
        return {"k": pdef(shp, ax, init="zeros"), "v": pdef(shp, ax, init="zeros"),
                "xk": pdef(xshp, ax, init="zeros"), "xv": pdef(xshp, ax, init="zeros")}
    if kind in ("mla", "mla_moe"):
        m = cfg.mla
        return {"ckv": pdef((batch, max_seq, m.kv_lora + m.d_rope), ("batch", "act_seq", None), init="zeros")}
    if kind == "rec":
        r = cfg.rnn_width or cfg.d_model
        return {
            "h": pdef((batch, r), ("batch", "ff"), init="zeros", dtype=torch.float32),
            "conv": pdef((batch, cfg.conv_width - 1, r), ("batch", None, "ff"), init="zeros"),
        }
    if kind == "mlstm":
        x = cfg.xlstm
        dh = x.expansion * cfg.d_model // x.n_heads
        return {
            "C": pdef((batch, x.n_heads, dh, dh), ("batch", "heads", None, None), init="zeros", dtype=torch.float32),
            "n": pdef((batch, x.n_heads, dh), ("batch", "heads", None), init="zeros", dtype=torch.float32),
            "m": pdef((batch, x.n_heads), ("batch", None), init="zeros", dtype=torch.float32),
        }
    if kind == "slstm":
        return {k: pdef((batch, cfg.d_model), ("batch", "ff"), init="zeros", dtype=torch.float32) for k in "cnmh"}
    raise ValueError(f"block kind {kind!r}")


def model_defs(cfg: ModelConfig) -> Params:
    """Full parameter tree (ParamDefs) for a model config."""
    d, v = cfg.d_model, cfg.vocab
    p: Params = {
        "embed": pdef((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": B.rmsnorm_defs(d),
    }
    if not cfg.tie_embeddings:
        p["head"] = pdef((d, v), ("embed", "vocab"))
    if cfg.enc_pattern:
        p["enc_groups"] = _stack_defs({f"b{i}": block_defs(cfg, k) for i, k in enumerate(cfg.enc_pattern)},
                                      cfg.enc_groups)
        p["enc_norm"] = B.rmsnorm_defs(d)
    if cfg.prefix:
        p["prefix"] = [block_defs(cfg, k) for k in cfg.prefix]
    if cfg.n_groups > 0:
        p["groups"] = _stack_defs({f"b{i}": block_defs(cfg, k) for i, k in enumerate(cfg.pattern)}, cfg.n_groups)
    if cfg.suffix:
        p["suffix"] = [block_defs(cfg, k) for k in cfg.suffix]
    return p


def _stack_defs(tree: Params, n: int) -> Params:
    def stack(dfn: ParamDef) -> ParamDef:
        return pdef((n,) + dfn.shape, ("layers",) + dfn.axes, dfn.init, dfn.scale, dfn.dtype)

    return nn.tree_map(stack, tree)


def model_cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> Params:
    c: Params = {}
    if cfg.prefix:
        c["prefix"] = [cache_defs(cfg, k, batch, max_seq) for k in cfg.prefix]
    if cfg.n_groups > 0:
        c["groups"] = _stack_defs(
            {f"b{i}": cache_defs(cfg, k, batch, max_seq) for i, k in enumerate(cfg.pattern)}, cfg.n_groups
        )
    if cfg.suffix:
        c["suffix"] = [cache_defs(cfg, k, batch, max_seq) for k in cfg.suffix]
    return c


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def apply_block(
    p: Params,
    x: torch.Tensor,
    kind: str,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
    cache_len: Optional[int] = None,
    enc_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """One block.  A decoder block (``"dec"``) attends over ``enc_out``
    uncached, and over its cache's ``xk`` / ``xv`` cached, which it carries
    into the new cache unchanged (``enc_out`` is then not read).

    Each branch's output is pinned to the batch layout before its residual
    add (``constrain_batch``) and each norm's output to the batch layout with
    every other dimension whole (``batch_only``), both the identity without
    a mesh.  On a mesh they are Megatron's reduction after a row-parallel
    matmul and its identity forward, reducing backward, before a
    column-parallel one (under sequence parallelism its reduce-scatter and
    all-gather).  Without them DTensor keeps an output projection's partial
    sum pending through the residual add and RMSNorm and runs the next
    matmul on it with its weights gathered, the tensor-parallel work done on
    every rank; the JAX package's partitioner reduces there unasked."""
    eps = cfg.norm_eps
    h = batch_only(B.apply_rmsnorm(p["norm1"], x, eps))
    if kind in ("attn", "local", "global", "moe", "enc", "dec"):
        sub = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        y, new_cache = B.apply_attn(p["attn"], h, cfg.attn_cfg(kind), positions=positions, cache=sub,
                                    cache_len=cache_len)
        if "post_norm1" in p:
            y = B.apply_rmsnorm(p["post_norm1"], y, eps)
        if kind == "dec":
            x = x + constrain_batch(y)
            hc = batch_only(B.apply_rmsnorm(p["norm_c"], x, eps))
            if cache is None:
                y, _ = B.apply_attn(p["cross"], hc, cfg.cross_cfg(), positions=positions, kv_source=enc_out)
            else:
                y, _ = B.apply_attn(p["cross"], hc, cfg.cross_cfg(), positions=positions,
                                    cache={"k": cache["xk"], "v": cache["xv"]})
                new_cache = dict(new_cache, xk=cache["xk"], xv=cache["xv"])
    elif kind in ("mla", "mla_moe"):
        y, new_cache = B.apply_mla(p["attn"], h, cfg.mla, positions=positions, cache=cache, cache_len=cache_len)
    elif kind == "rec":
        y, new_cache = B.apply_rglru(p["rec"], h, cfg.rglru_cfg(), cache=cache)
    elif kind == "mlstm":
        y, new_cache = B.apply_mlstm(p["mix"], h, cfg.xlstm, cache=cache)
        return x + constrain_batch(y), new_cache
    elif kind == "slstm":
        y, new_cache = B.apply_slstm(p["mix"], h, cfg.xlstm, cache=cache)
        return x + constrain_batch(y), new_cache
    else:
        raise ValueError(f"block kind {kind!r}")
    x = x + constrain_batch(y)

    h2 = batch_only(B.apply_rmsnorm(p["norm2"], x, eps))
    if kind in ("moe", "mla_moe"):
        y2 = B.apply_moe(p["moe"], h2, cfg.moe, cfg.ffn_kind)
    else:
        y2 = B.apply_ffn(p["ffn"], h2, cfg.ffn_kind)
    if "post_norm2" in p:
        y2 = B.apply_rmsnorm(p["post_norm2"], y2, eps)
    return x + constrain_batch(y2), new_cache


def _tree_slice(tree, i: int):
    return nn.tree_map(lambda x: x[i], tree)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` rematerialized in the backward by ``policy`` (the JAX package's ``_remat``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat policy {policy!r}: want none, full or dots")


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S, d) float32: sin then cos of each position times d / 2 frequencies
    from 1 down to 1 / 10000 (the JAX package's spacing, ``/ (half - 1)``)."""
    pos = positions.to(torch.float32)[:, None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device)
                     / max(half - 1, 1))
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not an index: DTensor shards its backward over a
    # vocab-sharded table (the dry run), not the index's (an index_put)
    x = torch.nn.functional.embedding(tokens, params["embed"])
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = batch_only(B.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps))
    logits = x @ (params["embed"].T if cfg.tie_embeddings else params["head"])
    logits = B.softcap(logits.to(torch.float32), cfg.final_softcap)
    mesh = get_mesh()
    if mesh is not None:
        shape = mesh_shape(mesh)
        if "model" in shape and cfg.vocab % shape["model"] == 0:
            # vocab-parallel logits: the fp32 (B, S, V) tensor stays sharded over the model axis
            daxes = tuple(a for a in ("pod", "data") if a in shape)
            bax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
            if bax is not None and logits.shape[0] % math.prod(shape[a] for a in daxes) == 0:
                logits = constrain(logits, bax, *([None] * (logits.ndim - 2)), "model")
            else:
                logits = constrain(logits, *([None] * (logits.ndim - 1)), "model")
    return logits


def run_encoder(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over pre-embedded frames (B, S_enc, d), in the
    weights' dtype (the conv frontend is a stub): sinusoidal positions, the
    ``enc_groups`` (rematerialized by ``cfg.remat`` under autograd), then
    ``enc_norm``."""
    S = frames.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=frames.device)
    x = constrain_batch(frames)
    if cfg.enc_positions == "sinusoidal":
        x = x + _sinusoidal(positions, cfg.d_model)[None].to(x.dtype)

    def group_fn(x, gp):
        for i, kind in enumerate(cfg.enc_pattern):
            x, _ = apply_block(gp[f"b{i}"], x, kind, cfg, positions=positions)
        return constrain_batch(x)

    group = _remat(group_fn, cfg.remat) if torch.is_grad_enabled() else group_fn
    for gi in range(cfg.enc_groups):
        x = group(x, _tree_slice(params["enc_groups"], gi))
    return B.apply_rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    *,
    vis_embeds: Optional[torch.Tensor] = None,  # (B, V, d) vlm prefix
    frames: Optional[torch.Tensor] = None,  # (B, S_enc, d) whisper encoder input
    cache: Optional[Params] = None,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits (B, V + S, V_vocab) float32, new_cache).  Uncached:
    ``cache=None``.  Cached (prefill into the cache, or decode): the V + S
    positions sit at ``cache_len .. cache_len + V + S - 1`` and the new cache
    is returned; the caller's cache is not modified.

    ``vis_embeds`` go before the token embeddings, cast to their dtype.  An
    encoder-decoder runs its encoder over ``frames``; its uncached forward
    needs them, its cached one reads the encoder's keys and values from the
    cache (``cross_kv``), so frames given there are encoded and not read, as
    in the JAX package."""
    x = embed_tokens(params, cfg, tokens)
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(x.dtype), x], dim=1)
    x = constrain_batch(x)
    S = x.shape[1]
    start = 0 if cache_len is None else int(cache_len)
    positions = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    if cfg.enc_positions == "sinusoidal":
        x = x + _sinusoidal(positions, cfg.d_model)[None].to(x.dtype)
    enc_out = None
    if cfg.enc_pattern and frames is not None:
        enc_out = run_encoder(params, cfg, frames)
    elif cfg.enc_pattern and cache is None:
        raise ValueError(f"{cfg.name}: the uncached forward of an encoder-decoder needs frames")

    def run(p, x, kind, c, enc_out):
        return apply_block(p, x, kind, cfg, positions=positions, cache=c, cache_len=start, enc_out=enc_out)

    new_cache: Params = {}
    for i, kind in enumerate(cfg.prefix):
        x, nc = run(params["prefix"][i], x, kind, None if cache is None else cache["prefix"][i], enc_out)
        new_cache.setdefault("prefix", []).append(nc)
    if cfg.n_groups > 0 and cache is None:

        def group_fn(x, gp, enc_out):
            for i, kind in enumerate(cfg.pattern):
                x, _ = run(gp[f"b{i}"], x, kind, None, enc_out)
            return constrain_batch(x)

        group = _remat(group_fn, cfg.remat) if torch.is_grad_enabled() else group_fn
        for gi in range(cfg.n_groups):
            x = group(x, _tree_slice(params["groups"], gi), enc_out)
    elif cfg.n_groups > 0:
        group_caches = []
        for gi in range(cfg.n_groups):
            gp, gc = _tree_slice(params["groups"], gi), _tree_slice(cache["groups"], gi)
            ncs = {}
            for i, kind in enumerate(cfg.pattern):
                x, ncs[f"b{i}"] = run(gp[f"b{i}"], x, kind, gc[f"b{i}"], enc_out)
            group_caches.append(ncs)
            x = constrain_batch(x)
        new_cache["groups"] = nn.tree_map(lambda *xs: torch.stack(xs), *group_caches)
    for i, kind in enumerate(cfg.suffix):
        x, nc = run(params["suffix"][i], x, kind, None if cache is None else cache["suffix"][i], enc_out)
        new_cache.setdefault("suffix", []).append(nc)
    return unembed(params, cfg, x), (new_cache if cache is not None else None)
