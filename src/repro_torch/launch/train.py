"""COSTREAM training launcher in PyTorch: builds the benchmark corpus and trains
every model artifact the experiment harnesses need, on a CUDA device.

The port of ``repro/launch/train.py``.  Stages (resumable; each skips
finished artifacts):

  main       5 per-metric GNN ensembles (paper SIV-A) of 3 members each on the
             22,000-trace corpus (80/10/10 split), batch 512, lr 1.5e-3,
             signature-exact banding; then the one serving bundle ``main``
  flat       flat-vector baselines [16] for the same 5 metrics
  extrap     8 restricted-range retrains for Exp 4 (4 hw dims x stronger/weaker)
  ablations  Exp 7a featurization variants + Exp 7b traditional message passing
  finetune   Exp 5b few-shot fine-tuning on filter-chain queries

The cost models train through the CUDA kernels (``GNNConfig(use_pallas=True)``;
with ``--device cpu`` the kernel wrappers run their plain versions), so the
exported bundle serves through them too.  Each stage returns what it trained
(None for an artifact that was stored already).

Run:  PYTHONPATH=src python -m repro_torch.launch.train --stage all
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.flat_vector import FlatVectorConfig, featurize_flat_traces
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import drop_hardware, drop_hw_features
from repro_torch.core.model import (
    ALL_METRICS,
    REGRESSION_METRICS,
    CostModelConfig,
    label_array,
)
from repro_torch.dsps import ranges
from repro_torch.dsps.generator import GeneratorConfig, Trace, WorkloadGenerator
from repro_torch.dsps.simulator import simulate
from repro_torch.launch import artifacts
from repro_torch.serve.bundle import CostModelBundle, corpus_fingerprint
from repro_torch.training.batching import dataset_from_traces, split_dataset, split_indices
from repro_torch.training.loop import TrainConfig, TrainResult, train_cost_model, train_flat_model

CORPUS_SEED = 42
SPLIT_SEED = 7
MAIN_CORPUS = 22_000
EXTRAP_CORPUS = 6_000
FINETUNE_N = 3_000
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


def _train_one(
    traces,
    metric: str,
    name: str,
    n_ensemble: int,
    epochs: int,
    transform=None,
    traditional_mp: bool = False,
    extra: Optional[Dict] = None,
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> Optional[TrainResult]:
    """Train and store one metric's ensemble; None when it is stored already.

    ``transform`` maps each featurized graph (the Exp-7a ablations),
    ``traditional_mp`` selects the Exp-7b forward, ``extra`` joins the stored
    manifest's training record.
    """
    if artifacts.exists("costream", name):
        print(f"[skip] {name}")
        return None
    t0 = time.time()
    tr, va, _ = split_dataset(dataset_from_traces(traces, metric, transform=transform), seed=SPLIT_SEED)
    cfg = CostModelConfig(
        metric=metric, gnn=GNNConfig(use_pallas=True), n_ensemble=n_ensemble, traditional_mp=traditional_mp
    )
    res = train_cost_model(
        tr,
        va,
        cfg,
        # signature-exact bands: these fixed corpora dwarf the batch size, so
        # every step runs row-trimmed stage-3 spans
        TrainConfig(epochs=epochs, batch_size=512, lr=1.5e-3, seed=seed, verbose=verbose, exact_banding=True),
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
            **(extra or {}),
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


def stage_flat(epochs: int, device=None) -> Dict[str, Optional[Tuple[object, float]]]:
    """The flat-vector baselines of the five metrics on the main corpus's
    train/validation split: metric -> (params, seconds), None if stored."""
    traces = main_corpus()
    x = featurize_flat_traces(traces)
    # the same partition split_dataset uses for the GNN models
    idx_tr, idx_va, _ = split_indices(len(traces), seed=SPLIT_SEED)
    out = {}
    for metric in ALL_METRICS:
        name = f"flat_{metric}"
        if artifacts.exists("flat", name):
            print(f"[skip] {name}")
            out[metric] = None
            continue
        t0 = time.time()
        y = label_array(traces, metric)
        task = "regression" if metric in REGRESSION_METRICS else "classification"
        cfg = FlatVectorConfig(task=task)
        params = train_flat_model(
            x[idx_tr],
            y[idx_tr],
            x[idx_va],
            y[idx_va],
            cfg,
            TrainConfig(epochs=epochs, batch_size=512, lr=1.5e-3),
            device=device,
        )
        artifacts.save_flat_model(name, params, cfg)
        out[metric] = (params, time.time() - t0)
        print(f"[done] {name}")
    return out


def extrap_generator(direction: str, dim: str) -> GeneratorConfig:
    spec = ranges.extrapolation_ranges()[direction]["train"]
    mapping = {
        "ram": ("ram_mb", "RAM_MB"),
        "cpu": ("cpu", "CPU"),
        "bandwidth": ("bandwidth_mbps", "BANDWIDTH_MBPS"),
        "latency": ("latency_ms", "LATENCY_MS"),
    }
    field, key = mapping[dim]
    return GeneratorConfig().with_hardware(**{field: tuple(spec[key])})


def stage_extrap(epochs: int, device=None) -> Dict[str, Optional[TrainResult]]:
    """One member a metric on each restricted-range corpus (Exp 4).

    Each corpus is seeded with ``CORPUS_SEED + hash((direction, dim)) % 1000``
    as the JAX package seeds it; ``hash`` of a tuple of strings depends on
    ``PYTHONHASHSEED``, so a corpus is reproducible within one process (and
    across processes only under a fixed ``PYTHONHASHSEED``).
    """
    out = {}
    for direction in ("stronger", "weaker"):
        for dim in ("ram", "cpu", "bandwidth", "latency"):
            cname = f"extrap_{direction}_{dim}"
            traces = corpus_cache(
                cname,
                lambda d=direction, m=dim: WorkloadGenerator(
                    extrap_generator(d, m), seed=CORPUS_SEED + hash((d, m)) % 1000
                ).corpus(EXTRAP_CORPUS),
            )
            for metric in ALL_METRICS:
                out[f"{cname}_{metric}"] = _train_one(
                    traces,
                    metric,
                    f"{cname}_{metric}",
                    n_ensemble=1,
                    epochs=epochs,
                    extra={"direction": direction, "dim": dim},
                    verbose=False,
                    device=device,
                )
    return out


def stage_ablations(epochs: int, device=None) -> Dict[str, Optional[TrainResult]]:
    traces = main_corpus()
    out = {}
    # Exp 7a: featurization variants for L_e — plus an equal-budget "full"
    # model so the Fig-12 comparison is apples-to-apples at these epochs
    for name, transform in (
        ("ablate_full_latency_e", None),
        ("ablate_no_hw_nodes_latency_e", drop_hardware),
        ("ablate_no_hw_feats_latency_e", drop_hw_features),
    ):
        out[name] = _train_one(
            traces, "latency_e", name, n_ensemble=3, epochs=epochs, transform=transform, device=device
        )
    # Exp 7b: traditional message passing for the regression metrics
    for metric in REGRESSION_METRICS:
        name = f"ablate_traditional_{metric}"
        out[name] = _train_one(
            traces, metric, name, n_ensemble=3, epochs=epochs, traditional_mp=True, device=device
        )
    return out


def chain_corpus(name: str, n: int, seed: int, chain_lengths=(2, 3, 4)) -> List:
    """Filter-chain queries unseen in training (Exp 5 / Exp 5b)."""

    def build():
        gen = WorkloadGenerator(seed=seed)
        out = []
        for i in range(n):
            ln = chain_lengths[i % len(chain_lengths)]
            q = gen.linear_query(name=f"{name}{i}", n_filters=ln)
            c = gen.cluster()
            p = gen.placement(q, c)
            out.append(Trace(query=q, cluster=c, placement=p, labels=simulate(q, c, p, rng=gen.rng)))
        return out

    return corpus_cache(name, build)


def finetune_corpus() -> List:
    return chain_corpus("finetune_chains", FINETUNE_N, CORPUS_SEED + 5)


def stage_finetune(epochs: int, device=None) -> Optional[TrainResult]:
    """``main_throughput`` fine-tuned on the filter-chain corpus (Exp 5b)."""
    name = "finetune_throughput"
    if artifacts.exists("costream", name):
        print(f"[skip] {name}")
        return None
    base_params, cfg = artifacts.load_cost_model("main_throughput")
    traces = finetune_corpus()
    ds = dataset_from_traces(traces, "throughput")
    tr, va, _ = split_dataset(ds, fractions=(0.9, 0.1, 0.0), seed=SPLIT_SEED)
    res = train_cost_model(
        tr,
        va,
        cfg,
        TrainConfig(epochs=epochs, batch_size=256, lr=3e-4, verbose=True),
        init_params=base_params,
        device=device,
    )
    artifacts.save_cost_model(name, res.params, cfg, extra={"finetuned_from": "main_throughput"})
    print(f"[done] {name}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="all", choices=STAGES)
    ap.add_argument("--epochs", type=int, default=26)
    ap.add_argument("--extrap-epochs", type=int, default=12)
    ap.add_argument("--ablation-epochs", type=int, default=16)
    ap.add_argument("--finetune-epochs", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.stage in ("all", "main"):
        stage_main(args.epochs, device=args.device)
    if args.stage in ("all", "flat"):
        stage_flat(args.epochs, device=args.device)
    if args.stage in ("all", "extrap"):
        stage_extrap(args.extrap_epochs, device=args.device)
    if args.stage in ("all", "ablations"):
        stage_ablations(args.ablation_epochs, device=args.device)
    if args.stage in ("all", "finetune"):
        stage_finetune(args.finetune_epochs, device=args.device)
    print(f"total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
