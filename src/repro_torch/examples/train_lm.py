"""LM training driver: any assigned architecture, synthetic token stream,
atomic checkpointing with restart, optional failure injection.

Default is a fast reduced config; ``--scale full --arch xlstm-125m`` trains
the real 125M config.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch xlstm-125m --steps 60 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma2-2b --inject-failure 20

The port of the JAX package's ``examples/train_lm.py``: the same flags,
defaults and batches (float32 weights from seed 0, batch ``step`` drawn from
``numpy.random.default_rng(step)``), plus ``--device`` (default: the CUDA
card; ``cpu`` runs the plain PyTorch path).  The step runs eagerly where the
JAX script jits it with donated buffers.  ``--inject-failure N`` exits with
code 17 right after step N, before that step's checkpoint; running the
script again (without the flag) resumes from the newest checkpoint.  The
checkpoints go under ``--ckpt-dir`` (default ``repro_torch_lm_ckpt`` in the
temporary directory, apart from the JAX script's).  ``main(argv)`` prints
what the JAX script prints and returns it as a dict (``losses``: step ->
loss).
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs import get_config, reduced
from repro_torch.models.params import count_params, materialize
from repro_torch.models.steps import TrainStepConfig, make_train_step
from repro_torch.models.transformer import model_defs
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint


def synthetic_batch(cfg, B, S, step, device):
    rng = np.random.default_rng(step)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch = {
            "tokens": rng.integers(0, cfg.vocab, (B, S - cfg.vis_len)).astype(np.int32),
            "vis_embeds": (rng.normal(size=(B, cfg.vis_len, cfg.d_model)) * 0.02).astype(np.float32),
        }
    if cfg.frontend == "audio":
        batch["frames"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--scale", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="simulate a crash at this step, then auto-restart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    device = nn.resolve_device(args.device, "train_lm")

    cfg = get_config(args.arch)
    if args.scale == "reduced":
        cfg = reduced(cfg)
    n_params = count_params(model_defs(cfg))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M layers={cfg.n_layers()}")

    train_step, opt = make_train_step(cfg, TrainStepConfig(lr=1e-3), device=device)
    params = materialize(torch.Generator(device).manual_seed(0), model_defs(cfg), dtype_override=torch.float32,
                         device=device)
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=device)}
    out = {"arch": cfg.name, "params": n_params, "losses": {}, "grad_norms": {}, "resumed_from": None}

    # fault tolerance: resume from the newest atomic checkpoint if present
    restored, step0, _ = restore_checkpoint(args.ckpt_dir, state)
    if restored is not None:
        state = restored
        out["resumed_from"] = int(step0)
        print(f"resumed from checkpoint at step {step0}")
    start = int(state["step"])

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, step, device)
        state, metrics = train_step(state, batch)
        out["losses"][step] = float(metrics["loss"])
        out["grad_norms"][step] = float(metrics["grad_norm"])
        if args.inject_failure and step == args.inject_failure:
            print(f"!! injected failure at step {step} — restart this script to resume")
            raise SystemExit(17)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {out['losses'][step]:.4f} "
                  f"gnorm {out['grad_norms'][step]:.3f} "
                  f"({(time.time() - t0):.1f}s)")
        if step > 0 and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step, state)
            print(f"checkpointed step {step}")
    save_checkpoint(args.ckpt_dir, args.steps, state)
    print("done; final checkpoint saved")
    out["seconds"] = time.time() - t0
    return out


if __name__ == "__main__":
    main()
