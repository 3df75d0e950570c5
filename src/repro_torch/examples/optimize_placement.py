"""End-to-end driver for the paper's use case: cost-based INITIAL operator
placement (paper SV, Fig. 4).

Trains small per-metric ensembles, bundles them, then for a set of streaming
queries runs heuristic placement [32] vs. COSTREAM-optimized placement
through the CostEstimator facade, with the simulator as ground truth.
Reports the measured L_p speedups.

    PYTHONPATH=src python -m repro_torch.examples.optimize_placement [--smoke] [--device cpu]

The port of the JAX package's ``examples/optimize_placement.py``: the same
flags, defaults, configs and seeds, plus ``--device`` (default: the CUDA
card; ``cpu`` runs the plain PyTorch path).  ``--smoke`` shrinks
corpus/epochs/queries to CI scale.  ``main(argv)`` prints what the JAX
script prints and returns it as a dict.
"""

import argparse
import time

import numpy as np

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.model import CostModelConfig
from repro_torch.dsps.generator import WorkloadGenerator
from repro_torch.dsps.simulator import SimulatorConfig, simulate
from repro_torch.placement.enumerate import heuristic_placement
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator
from repro_torch.training.batching import dataset_from_traces, split_dataset
from repro_torch.training.loop import TrainConfig, train_cost_model

SIM = SimulatorConfig(noise_sigma=0.0)


def train_bundle(traces, epochs: int, hidden: int, device) -> CostModelBundle:
    models = {}
    for metric in ("latency_p", "success", "backpressure"):
        ds = dataset_from_traces(traces, metric)
        tr, va, _ = split_dataset(ds)
        cfg = CostModelConfig(metric=metric, n_ensemble=3, gnn=GNNConfig(hidden=hidden))
        res = train_cost_model(tr, va, cfg, TrainConfig(epochs=epochs, batch_size=256), device=device)
        models[metric] = (res.params, cfg)
        print(f"trained {metric}: best val loss {res.best_val:.4f}")
    return CostModelBundle(models, meta={"epochs": epochs, "corpus": len(traces)})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny corpus/epochs for CI")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    n_corpus = 300 if args.smoke else 2000
    epochs = 2 if args.smoke else 8
    n_queries = 2 if args.smoke else 10
    k = 16 if args.smoke else 48
    refine = 1 if args.smoke else 2

    gen = WorkloadGenerator(seed=1)
    print("generating training corpus...")
    bundle = train_bundle(gen.corpus(n_corpus), epochs, hidden=32 if args.smoke else 48, device=args.device)
    estimator = CostEstimator.from_bundle(bundle, device=args.device)

    rng = np.random.default_rng(0)
    speedups, queries = [], []
    scored = 0
    t0 = time.perf_counter()
    for i in range(n_queries):
        q = gen.query(name=f"demo{i}")
        cluster = gen.cluster(6)
        base = heuristic_placement(q, cluster)
        base_lat = simulate(q, cluster, base, SIM).latency_p

        # vectorized sample -> batched multi-metric scoring -> hill-climb
        # refinement of the top candidates, all behind the facade's one-call
        # search entry point
        res = estimator.optimize(q, cluster, "latency_p", k=k, rng=rng, refine_rounds=refine)
        scored += res.n_candidates
        opt_lat = simulate(q, cluster, res.placement, SIM).latency_p
        speedups.append(base_lat / max(opt_lat, 1e-9))
        queries.append({"n_ops": q.n_ops(), "heuristic": list(base.assignment), "heuristic_ms": base_lat,
                        "costream_ms": opt_lat, "speedup": speedups[-1], "feasible": res.n_feasible,
                        "candidates": res.n_candidates})
        print(
            f"query {i} ({q.n_ops()} ops): heuristic {base_lat:9.1f} ms -> "
            f"costream {opt_lat:9.1f} ms   speedup {speedups[-1]:6.2f}x "
            f"({res.n_feasible}/{res.n_candidates} feasible candidates)"
        )
    dt = time.perf_counter() - t0
    print(f"\nmedian speedup: {np.median(speedups):.2f}x")
    # wall clock includes the first calls' warmup and the simulator
    # ground-truth runs
    print(f"end-to-end: {scored / dt:.0f} candidates scored/s (x3 metrics, incl. warmup+sim)")
    return {"device": args.device, "corpus": n_corpus, "epochs": epochs, "queries": queries,
            "median_speedup": float(np.median(speedups)), "candidates_per_s": scored / dt}


if __name__ == "__main__":
    main()
