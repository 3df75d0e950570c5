"""Config registry (port of ``repro/configs/base.py``): architectures x
input-shape grid.

Shapes (identical for every LM arch):
  train_4k     seq 4,096   global_batch 256   train_step
  prefill_32k  seq 32,768  global_batch 32    prefill_step
  decode_32k   seq 32,768  global_batch 128   serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     serve_step; SSM/hybrid only

``get_config`` answers for every architecture of ``ARCHS``; ``input_specs``
gives the dry run (``launch/dryrun.py``) each cell's inputs as ``meta``
tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import blocks as B
from repro_torch.models.params import abstract
from repro_torch.models.transformer import ModelConfig, model_cache_defs

ARCHS = (
    "internlm2-1.8b",
    "qwen3-8b",
    "deepseek-67b",
    "gemma2-2b",
    "recurrentgemma-2b",
    "arctic-480b",
    "deepseek-v2-236b",
    "internvl2-1b",
    "xlstm-125m",
    "whisper-base",
)

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-8b": "qwen3_8b",
    "deepseek-67b": "deepseek_67b",
    "gemma2-2b": "gemma2_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-125m": "xlstm_125m",
    "whisper-base": "whisper_base",
}

# archs whose decode state is sub-quadratic in context (run long_500k)
SUBQUADRATIC = ("recurrentgemma-2b", "xlstm-125m")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(arch)
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").config()


def cell_supported(arch: str, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 500k decode is not sub-quadratic (DESIGN.md SS5)"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny sizes."""
    kw: Dict[str, Any] = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        n_groups=min(cfg.n_groups, 2),
        enc_groups=min(cfg.enc_groups, 2),
        window=8 if cfg.window else None,
        vis_len=8 if cfg.vis_len else 0,
        rnn_width=64 if cfg.rnn_width else None,
        remat="none",
    )
    if cfg.mla is not None:
        kw["mla"] = B.MLAConfig(d_model=64, n_heads=4, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_ff=32,
            shared_ff=32 if cfg.moe.n_shared else 0,
            dense_ff=32 if cfg.moe.dense_residual else 0,
        )
    if cfg.xlstm is not None:
        kw["xlstm"] = B.XLSTMConfig(d_model=64, n_heads=4, expansion=2)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Inputs of the step that this cell runs, as empty ``meta`` tensors.

    train/prefill: {"tokens": (B, S) int32} (+ ``vis_embeds`` (B, V, d) with
    V = min(vis_len, S / 2) and S - V tokens, or ``frames`` (B, S, d), bf16).
    decode: {"tokens": (B, 1), "cache": <arch cache at S>, "cache_len": ()}.
    """
    Bsz, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            v = min(cfg.vis_len, S // 2)
            out["tokens"] = meta((Bsz, S - v), torch.int32)
            out["vis_embeds"] = meta((Bsz, v, cfg.d_model), torch.bfloat16)
        elif cfg.frontend == "audio":
            out["tokens"] = meta((Bsz, S), torch.int32)
            out["frames"] = meta((Bsz, S, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = meta((Bsz, S), torch.int32)
        return out
    # decode: one new token against a cache of S
    out["tokens"] = meta((Bsz, 1), torch.int32)
    out["cache"] = abstract(model_cache_defs(cfg, Bsz, S))
    out["cache_len"] = meta((), torch.int32)
    return out
