"""Fault-tolerant checkpointing: atomic snapshots of a state tree + resume.

The port of ``repro/training/checkpoint.py``, with the same on-disk format,
so either package reads what the other wrote.  Layout:
``<dir>/step_<n>/arrays.npz`` + ``manifest.json``.  Writes go to a temp
directory first and are atomically renamed, so a crash mid-write never
corrupts the latest checkpoint; a ``latest`` pointer file is updated last.
Leaves are keyed by their ``/``-joined path (dict keys, NamedTuple field
names, list and tuple indices), exactly as the JAX package flattens its
pytrees: the train state ``(params, opt_state, ef)`` gives ``0/hw_enc/
layers/0/w``, ``1/step``, ``1/mu/...``, ``2/residual/...``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn

SEP = "/"


def _flatten_with_paths(tree) -> List[Tuple[str, np.ndarray]]:
    return [(SEP.join(path), _host(leaf)) for path, leaf in nn.tree_leaves_with_paths(tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory: str,
    step: int,
    state,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Atomically persist ``state`` (a tree of tensors or arrays) at ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays = dict(_flatten_with_paths(state))
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(arrays.keys()),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic on same filesystem
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # update the 'latest' pointer last (atomic replace)
    ptr_tmp = os.path.join(directory, ".latest.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(directory, "latest"))
    _gc_old(directory, keep)
    return final


def _gc_old(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        # pointer ahead of a crashed write: fall back to newest complete dir
        steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
        if not steps:
            return None
        name = steps[-1]
    return int(name.split("_")[1])


def restore_checkpoint(directory: str, like, step: Optional[int] = None):
    """Restore a tree of the same structure as ``like``.

    Each leaf comes back as a tensor of ``like``'s leaf dtype on its device.
    Returns (state, step, extra) or (None, None, None) when nothing exists.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None, None
    path = os.path.join(directory, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def read(pth, leaf):
        key = SEP.join(pth)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)

    state = nn.tree_map_with_path(read, like)
    return state, manifest["step"], manifest.get("extra", {})
