"""Artifact store: trained model parameters + metadata under artifacts/.

The port of ``repro/launch/artifacts.py``, over the same directory and the
same format, so either package reads what the other wrote.  Params are saved
with the atomic checkpoint writer; metadata (model config, corpus seeds,
training history) lives in the manifest.  ``REPRO_ARTIFACTS`` overrides the
root (default: ``artifacts/`` at the repository root).  Cost models live
under ``costream/<name>``, flat-vector baselines under ``flat/<name>``,
serving bundles under ``bundles/<name>``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.flat_vector import FlatVectorConfig, init_flat_model
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.serve.bundle import CostModelBundle, _config_from_manifest, _config_to_manifest
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint

ROOT = os.environ.get("REPRO_ARTIFACTS", os.path.join(os.path.dirname(__file__), "../../../artifacts"))


def path(*parts: str) -> str:
    return os.path.abspath(os.path.join(ROOT, *parts))


def save_cost_model(name: str, params, cfg: CostModelConfig, extra: Optional[Dict] = None):
    d = path("costream", name)
    save_checkpoint(d, 0, params, extra={**_config_to_manifest(cfg), **(extra or {})}, keep=1)


def load_cost_model(name: str) -> Tuple[object, CostModelConfig]:
    """(params as CPU tensors, config) of a stored cost model."""
    d = path("costream", name)
    # read the manifest first to rebuild the config and the like-tree
    with open(os.path.join(d, "step_0000000000", "manifest.json")) as f:
        meta = json.load(f)["extra"]
    cfg = _config_from_manifest(meta)
    like = init_cost_model(torch.Generator().manual_seed(0), cfg)
    params, _, _ = restore_checkpoint(d, like)
    if params is None:
        raise FileNotFoundError(f"no checkpoint under {d}")
    return params, cfg


def save_flat_model(name: str, params, cfg: FlatVectorConfig, extra: Optional[Dict] = None):
    d = path("flat", name)
    meta = {"hidden": cfg.hidden, "n_layers": cfg.n_layers, "task": cfg.task, **(extra or {})}
    save_checkpoint(d, 0, params, extra=meta, keep=1)


def load_flat_model(name: str) -> Tuple[object, FlatVectorConfig]:
    """(params as CPU tensors, config) of a stored flat-vector baseline."""
    d = path("flat", name)
    with open(os.path.join(d, "step_0000000000", "manifest.json")) as f:
        meta = json.load(f)["extra"]
    cfg = FlatVectorConfig(hidden=meta["hidden"], n_layers=meta["n_layers"], task=meta["task"])
    like = init_flat_model(torch.Generator().manual_seed(0), cfg)
    params, _, _ = restore_checkpoint(d, like)
    if params is None:
        raise FileNotFoundError(f"no checkpoint under {d}")
    return params, cfg


def exists(kind: str, name: str) -> bool:
    return os.path.exists(path(kind, name, "latest"))


# -- serving bundles (serve/bundle.py) ---------------------------------------------


def save_bundle(name: str, bundle) -> str:
    return bundle.save(path("bundles", name))


def load_bundle(name: str) -> CostModelBundle:
    return CostModelBundle.load(path("bundles", name))


def bundle_exists(name: str) -> bool:
    return exists("bundles", name)
