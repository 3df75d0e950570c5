"""The versioned on-disk bundle of trained COSTREAM cost models.

The port of ``repro/serve/bundle.py``, in the same format both ways: it
loads, unchanged, a bundle that the JAX package wrote, and writes one the
JAX package loads,

    <dir>/step_0000000000/arrays.npz     every metric's stacked ensemble params
    <dir>/step_0000000000/manifest.json  schema + layout versions, configs, meta
    <dir>/latest                         pointer (atomic-write protocol)

with npz keys ``<metric>/<path>``, the ``/``-joined key path of each leaf
(``latency_p/op_enc/layers/0/w``).  The manifest pins two compatibility
contracts, checked on ``load``: ``schema_version`` (the bundle format) and
``layout`` (the slot layout the row-position-dependent weights were trained
against); a mismatch raises ``BundleVersionError``.  Params load as CPU
tensors; ``CostEstimator`` moves them to its device.  Bundles are written
with the atomic checkpoint writer (``training/checkpoint.py``);
``bundle_from_checkpoint`` exports the params of a ``train_cost_model``
checkpoint, and ``merge_bundles`` joins per-metric bundles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import MAX_DEPTH, MAX_HW, MAX_OPS, SLOT_RANGES
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.training.checkpoint import SEP, latest_step, save_checkpoint

BUNDLE_SCHEMA_VERSION = 1


def layout_descriptor() -> Dict:
    """The slot-layout contract bundles are pinned to (JSON-normalized)."""
    return {
        "slot_ranges": [list(r) for r in SLOT_RANGES],
        "max_ops": MAX_OPS,
        "max_hw": MAX_HW,
        "max_depth": MAX_DEPTH,
    }


class BundleVersionError(RuntimeError):
    """The bundle's schema or slot layout is incompatible with this build."""


class BundleIntegrityError(RuntimeError):
    """The bundle's on-disk arrays are unreadable (truncated/corrupt npz,
    missing or mis-shaped params leaves); raised by ``load(verify=True)``."""


def _config_to_manifest(cfg: CostModelConfig) -> Dict:
    return {
        "metric": cfg.metric,
        "n_ensemble": cfg.n_ensemble,
        "traditional_mp": cfg.traditional_mp,
        "gnn": dataclasses.asdict(cfg.gnn),
    }


def _config_from_manifest(spec: Dict) -> CostModelConfig:
    return CostModelConfig(
        metric=spec["metric"],
        n_ensemble=spec["n_ensemble"],
        traditional_mp=spec.get("traditional_mp", False),
        gnn=GNNConfig(**spec["gnn"]),
    )


@dataclass
class CostModelBundle:
    """All trained metric ensembles of one deployment + their configs + meta.

    ``models``: metric name -> (ensemble params tree, CostModelConfig), the
    dict shape ``CostEstimator`` consumes.  ``meta``: training provenance.
    """

    models: Dict[str, Tuple[object, CostModelConfig]]
    meta: Dict = field(default_factory=dict)

    @property
    def metrics(self) -> Tuple[str, ...]:
        return tuple(self.models)

    def config(self, metric: str) -> CostModelConfig:
        return self.models[metric][1]

    def params(self, metric: str):
        return self.models[metric][0]

    def save(self, directory: str) -> str:
        """Atomically persist the bundle; returns the written step directory."""
        if not self.models:
            raise ValueError("refusing to save an empty bundle")
        state = {m: params for m, (params, _) in self.models.items()}
        manifest = {
            "schema_version": BUNDLE_SCHEMA_VERSION,
            "layout": layout_descriptor(),
            "configs": {m: _config_to_manifest(cfg) for m, (_, cfg) in self.models.items()},
            "meta": self.meta,
        }
        return save_checkpoint(directory, 0, state, extra=manifest, keep=1)

    @classmethod
    def load(cls, directory: str, lazy: bool = True, verify: bool = False) -> "CostModelBundle":
        """Load a bundle, refusing incompatible schema/layout versions.

        The manifest is read eagerly; with ``lazy=True`` each metric's params
        are read from ``arrays.npz`` on first access.  ``verify=True`` reads
        every metric's params once up front and raises
        ``BundleIntegrityError`` on any unreadable or mis-shaped leaf.
        """
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no bundle under {directory}")
        step_dir = os.path.join(directory, f"step_{step:010d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)["extra"]
        _check_compatible(manifest, directory)
        cfgs = {m: _config_from_manifest(spec) for m, spec in manifest["configs"].items()}
        npz_path = os.path.join(step_dir, "arrays.npz")
        if verify:
            for m, cfg in cfgs.items():
                try:
                    _params_from_npz(npz_path, m, cfg, f"bundle arrays at {npz_path}")
                except Exception as e:
                    raise BundleIntegrityError(
                        f"bundle at {directory} failed verification for metric "
                        f"{m!r}: {e.__class__.__name__}: {e}"
                    ) from e
        models = LazyModels(step_dir, cfgs)
        if not lazy:
            models = {m: models[m] for m in cfgs}
        return cls(models=models, meta=manifest.get("meta", {}))


def _check_compatible(manifest: Dict, directory: str) -> None:
    got = manifest.get("schema_version")
    if got != BUNDLE_SCHEMA_VERSION:
        raise BundleVersionError(
            f"bundle at {directory} has schema_version={got!r}, but this build "
            f"reads v{BUNDLE_SCHEMA_VERSION}; re-export the bundle with a "
            "matching version (see docs/api.md#bundle-format)"
        )
    layout = manifest.get("layout")
    if layout != layout_descriptor():
        raise BundleVersionError(
            f"bundle at {directory} was trained against a different canonical "
            f"slot layout ({layout!r} vs {layout_descriptor()!r}); ensemble "
            "weights are row-position-dependent, so serving them under this "
            "build's depth-major layout would silently mis-predict — retrain "
            "or convert the bundle (docs/api.md#bundle-format)"
        )


def _params_from_npz(npz_path: str, prefix: str, cfg: CostModelConfig, origin: str):
    """One ensemble's params (CPU tensors) from the ``prefix``-keyed npz leaves.

    ``np.load`` only decompresses the members actually read, so one metric
    costs that metric's bytes.  The expected tree and shapes come from
    ``init_cost_model`` for ``cfg``.
    """
    like = init_cost_model(torch.Generator().manual_seed(0), cfg)
    with np.load(npz_path) as data:
        files = set(data.files)

        def read(path, leaf):
            key = prefix + SEP + SEP.join(path)
            if key not in files:
                raise KeyError(f"{origin} lacks params leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"params shape mismatch for {key}: stored {arr.shape} vs "
                    f"config {tuple(leaf.shape)} — wrong CostModelConfig for {origin}"
                )
            return torch.from_numpy(np.array(arr, dtype=np.float32))

        return nn.tree_map_with_path(read, like)


class LazyModels(Mapping):
    """Read-only metric -> (params, cfg) mapping that defers array loading.

    Keys come from the eagerly-read manifest; a metric's params hit disk on
    its first ``[]`` and are kept.
    """

    def __init__(self, step_dir: str, cfgs: Dict[str, CostModelConfig]):
        self._npz_path = os.path.join(step_dir, "arrays.npz")
        self._cfgs = dict(cfgs)
        self._loaded: Dict[str, Tuple[object, CostModelConfig]] = {}

    def __getitem__(self, metric: str) -> Tuple[object, CostModelConfig]:
        hit = self._loaded.get(metric)
        if hit is None:
            cfg = self._cfgs[metric]  # raises KeyError for unknown metrics
            params = _params_from_npz(
                self._npz_path, metric, cfg, f"bundle arrays at {self._npz_path}"
            )
            hit = self._loaded[metric] = (params, cfg)
        return hit

    def __iter__(self):
        return iter(self._cfgs)

    def __len__(self) -> int:
        return len(self._cfgs)


def corpus_fingerprint(traces) -> str:
    """Stable digest of a training corpus (size + every trace's labels), the
    JAX package's, so a bundle trained by either package names its corpus
    the same way.  ``CostEstimator.from_bundle`` warns on a mismatch."""
    h = hashlib.sha256(str(len(traces)).encode())
    for t in traces:
        for k, v in sorted(t.labels.as_dict().items()):
            h.update(k.encode())
            h.update(np.float64(v).tobytes())
    return h.hexdigest()[:16]


def bundle_from_checkpoint(ckpt_dir: str, cfg: CostModelConfig, meta: Optional[Dict] = None) -> CostModelBundle:
    """Export a ``train_cost_model`` checkpoint as a single-metric bundle.

    Training checkpoints persist the full step state ``(params, opt_state,
    ef)``; only the params (the ``0/``-prefixed leaves of the newest step)
    belong in a serving bundle.  Combine the bundles of several metrics with
    ``merge_bundles`` before serving.
    """
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no training checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        params = _params_from_npz(os.path.join(step_dir, "arrays.npz"), "0", cfg, f"checkpoint at {ckpt_dir}")
    except KeyError as e:
        raise KeyError(
            f"{e.args[0]}; was it written by train_cost_model (state = (params, opt_state, ef))?"
        ) from None
    return CostModelBundle(
        models={cfg.metric: (params, cfg)},
        meta={"exported_from": os.path.abspath(ckpt_dir), "step": int(step), **(meta or {})},
    )


def merge_bundles(*bundles: CostModelBundle) -> CostModelBundle:
    """Union of several bundles' models (later bundles win on metric clash).

    Meta keys agreeing across bundles merge flat; keys carrying *different*
    values are namespaced per source bundle as ``"<metrics>/<key>"``, so no
    metric's provenance is silently overwritten by another's.
    """
    models: Dict[str, Tuple[object, CostModelConfig]] = {}
    for b in bundles:
        models.update(b.models)
    first: Dict = {}
    conflicts = set()
    for b in bundles:
        for k, v in b.meta.items():
            if k in first and first[k] != v:
                conflicts.add(k)
            first.setdefault(k, v)
    meta = {k: v for k, v in first.items() if k not in conflicts}
    for b in bundles:
        ns = ",".join(b.metrics)
        for k, v in b.meta.items():
            if k in conflicts:
                meta[f"{ns}/{k}"] = v
    return CostModelBundle(models=models, meta=meta)
