"""The training loop of the COSTREAM cost models, in PyTorch.

The port of ``repro/training/loop.py:train_cost_model``: epochs iterate
(n_ops, depth) buckets (``bucket_dataset`` once, then ``bucketed_batches``
with the numpy batch order from ``default_rng(seed + 1)``), each step runs
ONE stacked forward for all ensemble members (``ensemble_loss``), its
backward, optional gradient compression (top-k with error feedback, or an
int8 round trip) and an Adam(W) update with global-norm clipping on a cosine
schedule.  Validation loss is the ensemble loss over the validation set in
one banded batch, divided by the number of members; early stopping keeps a
host copy of the best params.  Checkpoints are written atomically every
``ckpt_every`` steps, and ``resume=True`` continues from the newest one.

The step runs on ``device`` (default: the GPU; ``device="cpu"`` runs the
plain PyTorch path).  With ``GNNConfig.use_pallas`` the forward launches the
CUDA kernels and their ``autograd.Function`` backwards run the plain
versions' VJPs.  Params start from ``init_params`` (for example JAX-made
params converted with ``nn.params_from_numpy``) or from a
``torch.Generator`` seeded with ``seed``.  ``traditional_mp`` configs (the
Exp-7b ablation) take the same bucketed, banded loop; their forward ignores
the banding, as in the JAX package.

``train_flat_model`` / ``predict_flat`` are the flat-vector baseline's loop
and inference: Adam(W) on the same schedule, MSLE or BCE, the batch order
from ``default_rng(seed)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.flat_vector import FlatVectorConfig, forward_flat, init_flat_model
from repro_torch.core.graph import batch_banding
from repro_torch.core.model import CostModelConfig, bce_loss, ensemble_loss, init_cost_model, msle_loss
from repro_torch.training import optim
from repro_torch.training.batching import (
    GraphDataset,
    batch_to_device,
    bucket_dataset,
    bucketed_batches,
    n_batches,
    prefetch,
)
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.compression import EFState, ef_init, int8_roundtrip, topk_with_error_feedback


@dataclass
class TrainConfig:
    epochs: int = 30
    batch_size: int = 256
    lr: float = 1e-3
    weight_decay: float = 1e-5
    max_grad_norm: float = 5.0
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    resume: bool = False
    compression: Optional[str] = None  # None | "topk" | "int8"
    # signature-exact row-trimmed stage-3 bands (one banding per distinct
    # query signature instead of per depth class): for large fixed corpora
    exact_banding: bool = False
    topk_frac: float = 0.05
    early_stop_patience: int = 6
    log_every: int = 50
    verbose: bool = False


@dataclass
class TrainResult:
    params: object
    history: List[Dict[str, float]]
    best_val: float
    steps: int


def make_optimizer(train_cfg: TrainConfig, total_steps: int) -> optim.Optimizer:
    """Adam(W) on the cosine schedule with warmup ``min(100, total // 10)``."""
    return optim.adam(
        lr=optim.cosine_schedule(train_cfg.lr, total_steps, warmup_steps=min(100, total_steps // 10)),
        weight_decay=train_cfg.weight_decay,
        max_grad_norm=train_cfg.max_grad_norm,
    )


def _maybe_compress(grads, ef: EFState, gen: Optional[torch.Generator], cfg: TrainConfig):
    if cfg.compression == "topk":
        grads, ef, _ = topk_with_error_feedback(grads, ef, cfg.topk_frac)
    elif cfg.compression == "int8":
        grads = int8_roundtrip(grads, gen)
    return grads, ef


def loss_and_grads(params, g, y, model_cfg: CostModelConfig, banding):
    """``(ensemble_loss, its gradient)`` at ``params`` (a tree like it)."""
    live = nn.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = ensemble_loss(live, g, y, model_cfg, banding)
    grads = iter(torch.autograd.grad(loss, [leaf for _, leaf in nn.tree_leaves_with_paths(live)]))
    return loss.detach(), nn.tree_map(lambda _: next(grads), params)


def train_step(params, opt_state, ef, g, y, banding, model_cfg: CostModelConfig, opt: optim.Optimizer,
               train_cfg: TrainConfig, gen: Optional[torch.Generator] = None):
    """One step: loss, gradient, compression, update -> (params, opt_state, ef, loss)."""
    loss, grads = loss_and_grads(params, g, y, model_cfg, banding)
    grads, ef = _maybe_compress(grads, ef, gen, train_cfg)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optim.apply_updates(params, updates), opt_state, ef, loss


def _host_copy(tree):
    return nn.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def train_cost_model(
    dataset_train: GraphDataset,
    dataset_val: GraphDataset,
    model_cfg: CostModelConfig,
    train_cfg: TrainConfig = TrainConfig(),
    init_params=None,
    device=None,
) -> TrainResult:
    device = nn.resolve_device(device, "train_cost_model")
    if init_params is None:
        init_params = init_cost_model(torch.Generator().manual_seed(train_cfg.seed), model_cfg)
    params = nn.to_device(init_params, device)

    # bucket once: every epoch then iterates depth-major buckets, each with
    # its static banding — (n_ops, depth) classes by default, per-signature
    # exact bands under ``exact_banding``
    dataset_train, buckets = bucket_dataset(dataset_train, exact=train_cfg.exact_banding)
    steps_per_epoch = max(1, n_batches(buckets, train_cfg.batch_size))
    total = steps_per_epoch * train_cfg.epochs
    opt = make_optimizer(train_cfg, total)
    opt_state = opt.init(params)
    ef = ef_init(params)
    gen = torch.Generator(device).manual_seed(train_cfg.seed) if train_cfg.compression == "int8" else None

    start_step = 0
    if train_cfg.resume and train_cfg.ckpt_dir:
        restored, step, _ = restore_checkpoint(train_cfg.ckpt_dir, (params, opt_state, ef))
        if restored is not None:
            params, opt_state, ef = restored
            start_step = int(step)

    rng = np.random.default_rng(train_cfg.seed + 1)
    history: List[Dict[str, float]] = []
    best_val = float("inf")
    best_params = params
    bad_epochs = 0
    step = start_step

    if len(dataset_val):
        val_g, val_y = batch_to_device(dataset_val.graphs, dataset_val.labels, device)
        val_banding = batch_banding(dataset_val.graphs)

    for epoch in range(train_cfg.epochs):
        t0 = time.time()
        epoch_losses = []
        # the worker gathers and pins each batch; this thread copies it to the device
        it = prefetch(bucketed_batches(dataset_train, buckets, train_cfg.batch_size, rng=rng), device=device)
        for g, y, banding in it:
            params, opt_state, ef, loss_val = train_step(
                params, opt_state, ef, g, y, banding, model_cfg, opt, train_cfg, gen
            )
            epoch_losses.append(loss_val)
            step += 1
            if train_cfg.ckpt_dir and step % train_cfg.ckpt_every == 0:
                save_checkpoint(train_cfg.ckpt_dir, step, (params, opt_state, ef))
        if len(dataset_val):
            with torch.no_grad():
                vl = float(ensemble_loss(params, val_g, val_y, model_cfg, val_banding) / model_cfg.n_ensemble)
        else:
            vl = float("nan")
        history.append(
            {
                "epoch": epoch,
                "train_loss": float(np.mean(torch.stack(epoch_losses).double().cpu().numpy()))
                if epoch_losses
                else float("nan"),
                "val_loss": vl,
                "seconds": time.time() - t0,
            }
        )
        if train_cfg.verbose:
            print(
                f"[{model_cfg.metric}] epoch {epoch} train {history[-1]['train_loss']:.4f} "
                f"val {vl:.4f} ({history[-1]['seconds']:.1f}s)"
            )
        if vl < best_val - 1e-4:
            best_val = vl
            best_params = _host_copy(params)  # a snapshot on the host, as the JAX package keeps
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= train_cfg.early_stop_patience:
                break

    if train_cfg.ckpt_dir:
        save_checkpoint(train_cfg.ckpt_dir, step, (best_params, opt_state, ef))
    return TrainResult(params=_host_copy(best_params), history=history, best_val=best_val, steps=step)


# -- flat-vector baseline ---------------------------------------------------------------


def train_flat_model(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    cfg: FlatVectorConfig,
    train_cfg: TrainConfig = TrainConfig(),
    device=None,
):
    """Train the flat-vector MLP; returns the best params (CPU tensors).

    Adam(W) on the cosine schedule with warmup ``min(100, total // 10)`` over
    ``len(x_train) // batch_size`` steps an epoch, MSLE (regression) or BCE
    (classification), the batch order from ``default_rng(seed)``, batches of
    fewer than 2 rows skipped, early stopping on the validation loss with a
    host copy of the best params.  Runs on ``device`` (default: the GPU).
    """
    device = nn.resolve_device(device, "train_flat_model")
    params = nn.to_device(init_flat_model(torch.Generator().manual_seed(train_cfg.seed), cfg), device)
    steps_per_epoch = max(1, len(x_train) // train_cfg.batch_size)
    opt = make_optimizer(train_cfg, steps_per_epoch * train_cfg.epochs)
    opt_state = opt.init(params)
    base_loss = msle_loss if cfg.task == "regression" else bce_loss
    x_tr, y_tr, x_va, y_va = nn.arrays_to_device(
        [np.asarray(a, dtype=np.float32) for a in (x_train, y_train, x_val, y_val)], device
    )
    rng = np.random.default_rng(train_cfg.seed)
    best_val, best_params, bad = float("inf"), _host_copy(params), 0
    for _ in range(train_cfg.epochs):
        order = rng.permutation(len(x_train))
        for s in range(0, len(order), train_cfg.batch_size):
            idx = order[s : s + train_cfg.batch_size]
            if idx.size < 2:
                continue
            (i,) = nn.arrays_to_device([idx], device)
            live = nn.tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = base_loss(forward_flat(live, x_tr[i]), y_tr[i])
            grads = iter(torch.autograd.grad(loss, [p for _, p in nn.tree_leaves_with_paths(live)]))
            updates, opt_state = opt.update(nn.tree_map(lambda _: next(grads), params), opt_state, params)
            params = optim.apply_updates(params, updates)
        if len(x_val):
            with torch.no_grad():
                vl = float(base_loss(forward_flat(params, x_va), y_va))
        else:
            vl = float("nan")
        if vl < best_val - 1e-4:
            best_val, best_params, bad = vl, _host_copy(params), 0
        else:
            bad += 1
            if bad >= train_cfg.early_stop_patience:
                break
    return best_params


def predict_flat(params, x: np.ndarray, task: str, device=None) -> np.ndarray:
    """Cost-space predictions (regression) or 0/1 votes (classification) of
    the flat-vector MLP for ``x`` (N, FLAT_DIM), computed on ``device``
    (default: the GPU)."""
    device = nn.resolve_device(device, "predict_flat")
    (xd,) = nn.arrays_to_device([np.asarray(x, dtype=np.float32)], device)
    with torch.no_grad():
        raw = forward_flat(nn.to_device(params, device), xd).cpu().numpy()
    if task == "regression":
        return np.expm1(raw).clip(min=0.0)
    return (raw > 0).astype(np.int64)
