"""COSTREAM training launcher in PyTorch: builds the benchmark corpus and trains
the main cost models on a CUDA device.

The port of ``repro/launch/train.py``'s ``main`` stage:

  main   5 per-metric GNN ensembles (paper SIV-A) of 3 members each on the
         22,000-trace corpus (80/10/10 split), batch 512, lr 1.5e-3,
         signature-exact banding; then the one serving bundle ``main``

Resumable: each metric skips a finished artifact.  The models train through
the CUDA kernels (``GNNConfig(use_pallas=True)``; with ``--device cpu`` the
kernel wrappers run their plain versions), so the exported bundle serves
through them too.  The other stages (flat, extrap, ablations, finetune) are
not ported yet (ROADMAP.md queue 1, item 8).

Run:  PYTHONPATH=src python -m repro_torch.launch.train --stage main
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, List, Optional

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.model import ALL_METRICS, CostModelConfig
from repro_torch.dsps.generator import WorkloadGenerator
from repro_torch.launch import artifacts
from repro_torch.serve.bundle import CostModelBundle, corpus_fingerprint
from repro_torch.training.batching import dataset_from_traces, split_dataset
from repro_torch.training.loop import TrainConfig, TrainResult, train_cost_model

CORPUS_SEED = 42
SPLIT_SEED = 7
MAIN_CORPUS = 22_000
STAGES = ("all", "main", "flat", "extrap", "ablations", "finetune")


def corpus_cache(name: str, build) -> List:
    """The traces ``build()`` makes, pickled under ``artifacts/corpus`` once.

    The file is ``<name>.torch.pkl``: the JAX package's ``<name>.pkl`` holds
    its own classes, which this package never unpickles.
    """
    os.makedirs(artifacts.path("corpus"), exist_ok=True)
    p = artifacts.path("corpus", f"{name}.torch.pkl")
    if os.path.exists(p):
        with open(p, "rb") as f:
            return pickle.load(f)
    traces = build()
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(traces, f)
    os.replace(tmp, p)
    return traces


def main_corpus() -> List:
    return corpus_cache("main", lambda: WorkloadGenerator(seed=CORPUS_SEED).corpus(MAIN_CORPUS))


def _train_one(traces, metric: str, name: str, n_ensemble: int, epochs: int, device=None) -> Optional[TrainResult]:
    """Train and store one metric's ensemble; None when it is stored already.

    The JAX package's featurization transforms, traditional message passing
    and per-stage seeds serve the stages of item 8 and come with them.
    """
    if artifacts.exists("costream", name):
        print(f"[skip] {name}")
        return None
    t0 = time.time()
    tr, va, _ = split_dataset(dataset_from_traces(traces, metric), seed=SPLIT_SEED)
    cfg = CostModelConfig(metric=metric, gnn=GNNConfig(use_pallas=True), n_ensemble=n_ensemble)
    res = train_cost_model(
        tr,
        va,
        cfg,
        # signature-exact bands: these fixed corpora dwarf the batch size, so
        # every step runs row-trimmed stage-3 spans
        TrainConfig(epochs=epochs, batch_size=512, lr=1.5e-3, verbose=True, exact_banding=True),
        device=device,
    )
    artifacts.save_cost_model(
        name,
        res.params,
        cfg,
        extra={
            "best_val": res.best_val,
            "steps": res.steps,
            "history": res.history,
            "seconds": time.time() - t0,
        },
    )
    print(f"[done] {name} val={res.best_val:.4f} in {time.time() - t0:.0f}s")
    return res


def stage_main(epochs: int, device=None) -> Dict[str, Optional[TrainResult]]:
    """Train the five metrics' ensembles, then export the bundle ``main``."""
    traces = main_corpus()
    results = {m: _train_one(traces, m, f"main_{m}", n_ensemble=3, epochs=epochs, device=device) for m in ALL_METRICS}
    export_main_bundle(epochs)
    return results


def export_main_bundle(epochs: int):
    """Assemble the five per-metric ensembles into the ONE versioned serving
    artifact (``serve.bundle.CostModelBundle``); the loose per-metric
    checkpoints stay as the resumable training artifacts."""
    if artifacts.bundle_exists("main"):
        print("[skip] bundle main")
        return
    missing = [m for m in ALL_METRICS if not artifacts.exists("costream", f"main_{m}")]
    if missing:
        print(f"[warn] bundle main not exported: metrics not trained yet {missing}")
        return
    bundle = CostModelBundle(
        models={m: artifacts.load_cost_model(f"main_{m}") for m in ALL_METRICS},
        meta={
            "stage": "main",
            "corpus_seed": CORPUS_SEED,
            "split_seed": SPLIT_SEED,
            "corpus_size": MAIN_CORPUS,
            # provenance: CostEstimator.from_bundle(corpus_fingerprint=...)
            # warns when served against data from a different corpus
            "corpus_fingerprint": corpus_fingerprint(main_corpus()),
            "epochs": epochs,
        },
    )
    artifacts.save_bundle("main", bundle)
    print(f"[done] bundle main ({', '.join(bundle.metrics)})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="main", choices=STAGES)
    ap.add_argument("--epochs", type=int, default=26)
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.stage != "main":
        raise NotImplementedError(
            f"stage {args.stage!r} is not ported yet (only 'main' is): ROADMAP.md queue 1, item 8."
        )
    t0 = time.time()
    stage_main(args.epochs, device=args.device)
    print(f"total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
