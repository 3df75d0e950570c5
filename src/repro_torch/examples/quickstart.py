"""Quickstart: generate a workload corpus, train a COSTREAM latency model,
save it as a versioned CostModelBundle, and serve predictions for unseen
placed queries through the CostEstimator facade.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--smoke] [--device cpu]

The port of the JAX package's ``examples/quickstart.py``: the same flags,
defaults, configs and seeds, plus ``--device`` (default: the CUDA card;
``cpu`` runs the plain PyTorch path).  ``--smoke`` shrinks corpus/epochs to
CI scale.  ``main(argv)`` prints what the JAX script prints and returns it
as a dict.
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.metrics import qerror_summary
from repro_torch.core.model import CostModelConfig
from repro_torch.dsps.generator import WorkloadGenerator
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator
from repro_torch.serve.service import PlacementService
from repro_torch.training.batching import dataset_from_traces, split_dataset
from repro_torch.training.loop import TrainConfig, train_cost_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="tiny corpus/epochs for CI")
    ap.add_argument("--corpus", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    n_corpus = args.corpus or (160 if args.smoke else 1500)
    epochs = args.epochs or (2 if args.smoke else 10)
    hidden = 24 if args.smoke else 48
    out = {"device": args.device, "corpus": n_corpus, "epochs": epochs, "hidden": hidden}

    # 1. benchmark corpus (paper SVI): random queries x hardware x placements,
    #    labeled by the DSPS cost simulator
    gen = WorkloadGenerator(seed=0)
    traces = gen.corpus(n_corpus)
    out["backpressured"] = int(sum(t.labels.backpressure == 0 for t in traces))
    out["failed"] = int(sum(t.labels.success == 0 for t in traces))
    print(f"corpus: {len(traces)} traces, {out['backpressured']} backpressured, {out['failed']} failed")

    # 2. train a processing-latency cost model (ensemble of 2 for speed)
    ds = dataset_from_traces(traces, "latency_p")
    train, val, test = split_dataset(ds)
    cfg = CostModelConfig(metric="latency_p", n_ensemble=2, gnn=GNNConfig(hidden=hidden))
    result = train_cost_model(
        train, val, cfg, TrainConfig(epochs=epochs, batch_size=256, verbose=not args.smoke), device=args.device
    )
    out["best_val"] = result.best_val

    # 3. package the trained ensemble as the ONE versioned serving artifact
    #    and round-trip it through disk, exactly what a deployment loads
    bundle = CostModelBundle(
        models={"latency_p": (result.params, cfg)},
        meta={"corpus": n_corpus, "epochs": epochs, "best_val": result.best_val},
    )
    # load() is lazy by default (params deserialize on first use), so the
    # bundle directory must outlive the estimator serving from it
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "latency_bundle")
        bundle.save(path)
        served = CostModelBundle.load(path)
        print(f"bundle round-trip: metrics={served.metrics} meta={served.meta}")
        out["bundle_metrics"] = list(served.metrics)
        out.update(serve_session(served, gen, test, args.device))
    return out


def serve_session(served, gen, test, device) -> dict:
    # 4. zero-shot predictions on unseen placed queries via the facade
    est = CostEstimator.from_bundle(served, device=device)
    pred = est.estimate(test.graphs, metrics=["latency_p"])["latency_p"]
    out = {"qerror": qerror_summary(test.labels, pred),
           "queries": [{"true_ms": float(test.labels[i]), "predicted_ms": float(pred[i])} for i in range(3)]}
    print("\nq-error on held-out queries:", out["qerror"])
    for i in range(3):
        print(f"  query {i}: true {test.labels[i]:9.1f} ms   predicted {pred[i]:9.1f} ms")

    # 5. serving a heterogeneous stream: many DISTINCT small queries arrive
    #    concurrently, each scoring a couple of candidate placements.  The
    #    PlacementService groups score requests per metrics tuple and answers
    #    a whole dispatch-bound drain with ONE merged cross-query forward
    #    instead of one per structure.
    rng = np.random.default_rng(7)
    stream = []
    for i, kind in enumerate(["linear", "two_way", "three_way", "linear"] * 2):
        q = gen.query(kind=kind, name=f"stream{i}")
        c = gen.cluster(3 + i % 5)
        stream.append((q, c, sample_assignment_matrix(q, c, 2, rng)))
    svc = PlacementService(est, auto_start=False)  # queue first: one drain
    futures = [svc.submit_score(q, c, a, ["latency_p"]) for q, c, a in stream]
    svc.start()
    answers = [f.result() for f in futures]
    svc.close()
    out["stream"] = {"queries": len(stream), "forwards": svc.stats.n_forwards,
                     "cross_query": svc.stats.n_cross_query, "best": []}
    print(f"\nheterogeneous stream: {len(stream)} distinct queries answered by "
          f"{svc.stats.n_forwards} fused forward(s) "
          f"({svc.stats.n_cross_query} cross-query coalesced)")
    for i in (0, 1):
        best = answers[i]["latency_p"].argmin()
        out["stream"]["best"].append(float(answers[i]["latency_p"][best]))
        print(f"  {stream[i][0].name}: best of {len(answers[i]['latency_p'])} "
              f"candidates predicts {answers[i]['latency_p'][best]:9.1f} ms")
    return out


if __name__ == "__main__":
    main()
