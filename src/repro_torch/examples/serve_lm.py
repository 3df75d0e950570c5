"""Batched decode serving: KV-cached single-token steps over a request batch.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch recurrentgemma-2b --tokens 12 [--device cpu]

The port of the JAX package's ``examples/serve_lm.py``: the same flags and
defaults (the reduced config, float32 weights from seed 0, the cache from
seed 1), plus ``--device`` (default: the CUDA card, where RecurrentGemma's
RG-LRU scan runs the ``linear_scan`` kernel; ``cpu`` runs the plain PyTorch
path).  Each step runs eagerly where the JAX script jits it.  ``main(argv)``
prints what the JAX script prints and returns it as a dict.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs import get_config, reduced
from repro_torch.models.params import count_params, materialize
from repro_torch.models.steps import make_serve_step
from repro_torch.models.transformer import model_cache_defs, model_defs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    device = nn.resolve_device(args.device, "serve_lm")

    cfg = reduced(get_config(args.arch))
    n_params = count_params(model_defs(cfg))
    print(f"serving {cfg.name} (reduced, {n_params / 1e6:.1f}M params), "
          f"batch={args.batch}, cache={args.max_seq}")

    params = materialize(torch.Generator(device).manual_seed(0), model_defs(cfg), dtype_override=torch.float32,
                         device=device)
    cache = materialize(torch.Generator(device).manual_seed(1), model_cache_defs(cfg, args.batch, args.max_seq),
                        device=device)
    cache = nn.tree_map(lambda x: x.float() if x.dtype == torch.bfloat16 else x, cache)
    serve_step = make_serve_step(cfg, device=device)

    # prompt: one BOS-ish token per request
    toks = torch.ones((args.batch, 1), dtype=torch.int32, device=device)
    out = [toks]
    t0 = time.time()
    for i in range(args.tokens):
        logits, cache, toks = serve_step(params, cache, toks, i)
        out.append(toks)
    seqs = torch.cat(out, dim=1).cpu().numpy()  # waits for the last step
    dt = time.time() - t0
    print(f"decoded {args.tokens} tokens x {args.batch} requests in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  request {b}: {seqs[b].tolist()}")
    return {"arch": cfg.name, "params": n_params, "batch": args.batch, "tokens": args.tokens, "seconds": dt,
            "tokens_per_s": args.tokens * args.batch / dt, "sequences": np.asarray(seqs).tolist(),
            "logits_finite": bool(torch.isfinite(logits).all())}


if __name__ == "__main__":
    main()
