#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Each phase prints one JSON line:
  build    nvcc build of every kernel (time; registers and shared memory per kernel)
  kernels  each CUDA kernel against its plain PyTorch version at the main path's
           shapes (max abs error beside the tolerance; kernel, plain and bound ms)
  serve    a full-width COSTREAM model (5 metrics x 3 members, hidden 64,
           use_pallas=True) answering estimate / score / optimize requests,
           each answer held against the same estimator on the CPU
then the kernel summary line, the card's name and power limit, and the status
line.  Any failure exits nonzero; so does a machine without a CUDA device, or
a directory that holds this script and nothing else of the repository.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-5  # rtol = atol for kernel against plain version
SERVE_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    """Least time for the work on this card: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import nn
    from repro_torch.core import gnn
    from repro_torch.core.graph import (
        SLOT_RANGES,
        batch_graphs,
        build_a_place_batch,
        build_graph,
        build_graph_skeleton,
        query_static,
    )
    from repro_torch.core.model import (
        ALL_METRICS,
        CLASSIFICATION_METRICS,
        REGRESSION_METRICS,
        CostModelConfig,
        forward_ensemble,
        init_cost_model,
    )
    from repro_torch.dsps import WorkloadGenerator
    from repro_torch.kernels import _build
    from repro_torch.kernels.banked_mlp import ops as bank_ops
    from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
    from repro_torch.kernels.mp_update import ops as mp_ops
    from repro_torch.kernels.mp_update.ref import mp_update_ref
    from repro_torch.placement.enumerate import sample_assignment_matrix
    from repro_torch.serve.estimator import CostEstimator, graphs_to_device
    from repro_torch.serve.stacking import stack_metric_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": b["seconds"], "ptxas": b["ptxas"]} for n, b in built.items()}})

    # -- inputs of the main path: a full-width model and a real trace batch --------
    E_MEMBERS = 3
    gcfg = gnn.GNNConfig(hidden=64, enc_layers=2, update_layers=2, readout_layers=2, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {}
    for m in ALL_METRICS:
        cfg = CostModelConfig(metric=m, gnn=gcfg, n_ensemble=E_MEMBERS)
        models[m] = (init_cost_model(gen, cfg), cfg)
    H = gcfg.hidden
    E = E_MEMBERS * len(ALL_METRICS)
    stacked = nn.to_device(stack_metric_models(models).params, dev)  # (15, ...) leaves

    t0 = time.perf_counter()
    workload = WorkloadGenerator(seed=0)
    traces = workload.corpus(4096)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_batch = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    t_featurize = time.perf_counter() - t0
    g = graphs_to_device(host_batch, dev)
    B, N = host_batch.op_x.shape[:2]
    W = host_batch.hw_x.shape[1]

    # -- 2. kernels against their plain versions -------------------------------------
    def cuda_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def compare(name, case, kernel, plain, flops, nbytes):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
        b_ms, b_by = bound(flops, nbytes)
        row = {"phase": "kernels", "kernel": name, "case": case, "shape": list(got.shape),
               "max_abs_err": err, "tol": TOL, "ok": ok, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {case}: kernel disagrees with its plain version (max abs err {err})")
        return row

    def bank_case(case, params, x, ranges, shared_input):
        (l1, l2) = params["layers"]
        Ex, Bx, Nx, F = x.shape
        T, H1, H2 = l1["w"].shape[1], l1["w"].shape[3], l2["w"].shape[3]
        rows = Ex * Bx * Nx
        flops = 2.0 * rows * (F * H1 + H1 * H2)
        nbytes = 4.0 * ((1 if shared_input else Ex) * Bx * Nx * F + rows * H2
                        + Ex * T * (F * H1 + H1 + H1 * H2 + H2))
        return compare("banked_mlp", case, lambda: bank_ops.banked_mlp_slotted(params, x, ranges),
                       lambda: banked_mlp_slotted_ref(params, x, ranges), flops, nbytes)

    def hw_bank(p):
        return {"layers": [{"w": l["w"][:, None], "b": l["b"][:, None]} for l in p["layers"]]}

    rng = torch.Generator().manual_seed(1)
    x_upd = torch.randn((E, B, N, 2 * H), generator=rng).to(dev)
    rows = [
        bank_case("op_enc, F=39, T=5, member stride 0", stacked["op_enc"],
                  g.op_x.expand(E, *g.op_x.shape), SLOT_RANGES, True),
        bank_case("hw_enc, F=4, T=1, member stride 0", hw_bank(stacked["hw_enc"]),
                  g.hw_x.expand(E, *g.hw_x.shape), ((0, 0, W),), True),
        bank_case("op_upd, F=128, T=5", stacked["op_upd"], x_upd, SLOT_RANGES, False),
    ]
    del x_upd

    def mp_case(case, h, a_flow, depth, mask, d, ranges, span=None, parent_rows=None):
        Eh, Bh, Nh, Hh = h.shape
        s, e = span if span is not None else (0, Nh)
        p = parent_rows if parent_rows is not None else Nh
        sel = (depth[..., s:e] == d) & (mask[..., s:e] > 0)
        n_sel = Eh * (int(sel.sum()) * (Bh if depth.ndim == 1 else 1))
        _, T, _, H1 = stacked["op_upd"]["layers"][0]["w"].shape
        flops = 2.0 * n_sel * (p * Hh + 2 * Hh * H1 + H1 * Hh)
        graph_bytes = a_flow.numel() * 4 + depth.numel() * 4 + mask.numel() * 4
        nbytes = 4.0 * (2 * h.numel() + Eh * T * (2 * Hh * H1 + H1 + H1 * Hh + Hh)) + graph_bytes
        kw = {} if span is None else {"row_span": span, "parent_rows": parent_rows}
        return compare("mp_update", case,
                       lambda: mp_ops.mp_update(stacked["op_upd"], h, a_flow, depth, mask, d, ranges, **kw),
                       lambda: mp_update_ref(stacked["op_upd"], h, a_flow, depth, mask, d, ranges, **kw),
                       flops, nbytes)

    h_full = torch.randn((E, B, N, H), generator=rng).to(dev)
    rows.append(mp_case("scan step, full width, d=2, per-graph fields", h_full, g.a_flow, g.op_depth,
                        g.op_mask, 2, SLOT_RANGES))
    # the placed path: one query's shared skeleton, trimmed depth-major layout
    q, c = workload.query(kind="three_way", name="smoke"), workload.cluster(6)
    static = query_static(q)
    order, _, _, levels = gnn._trimmed_layout(static)
    d_lvl, span, lvl_ranges, p_rows = max(levels, key=lambda lv: lv[1][1] - lv[1][0])
    skel = graphs_to_device(build_graph_skeleton(q, c), dev)
    idx = torch.tensor(order, device=dev)
    a_trim = skel.a_flow.index_select(0, idx).index_select(1, idx).contiguous()
    depth_trim = skel.op_depth.index_select(0, idx).contiguous()
    ones = torch.ones(len(order), device=dev)
    h_trim = torch.randn((E, 256, len(order), H), generator=rng).to(dev)
    rows.append(mp_case(f"placed level d={d_lvl}, span {span}, parent_rows {p_rows}, shared fields",
                        h_trim, a_trim, depth_trim, ones, d_lvl, lvl_ranges, span, p_rows))
    h_pad = torch.randn((E, 256, N, H), generator=rng).to(dev)
    rows.append(mp_case("full width, d=1, shared (N, N) skeleton", h_pad, skel.a_flow, skel.op_depth,
                        skel.op_mask, 1, SLOT_RANGES))
    del h_full, h_trim, h_pad
    torch.cuda.synchronize()

    # -- 3. serve: the port's main path through its entry points -----------------
    est = CostEstimator(models)
    cpu = CostEstimator(models, device="cpu")
    counters = (bank_ops.banked_mlp_slotted, mp_ops.mp_update)

    def launches():
        return tuple(k.launches for k in counters)

    def both_moved(before, what):
        after = launches()
        if not all(a > b for a, b in zip(after, before)):
            raise AssertionError(f"{what}: kernel launch counters did not move ({before} -> {after})")
        return [a - b for a, b in zip(after, before)]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def check_answers(what, got, want, raw):
        """Regression within SERVE_RTOL; votes equal where every member's
        logit in ``raw`` (CPU, metric -> (E, B)) is clear of 0 by 1e-3."""
        for m in want:
            a, b = np.asarray(got[m]), np.asarray(want[m])
            if m in REGRESSION_METRICS:
                if not np.allclose(a, b, rtol=SERVE_RTOL, atol=1e-6):
                    raise AssertionError(f"{what} {m}: card and CPU disagree (max rel err "
                                         f"{float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))})")
            else:
                clear = (np.abs(raw[m]) > 1e-3).all(axis=0)
                if not np.array_equal(a[clear], b[clear]):
                    raise AssertionError(f"{what} {m}: votes differ away from the threshold")

    torch.cuda.reset_peak_memory_stats()
    bank_ops.banked_mlp_slotted.launches = 0
    mp_ops.mp_update.launches = 0

    serve = {"phase": "serve", "model": {"hidden": H, "metrics": len(ALL_METRICS), "members": E_MEMBERS,
                                         "use_pallas": True}}
    # estimate: 4096 traces, full-depth scan plan
    before = launches()
    est_out, ms_first = timed(lambda: est.estimate(host_batch))
    delta = both_moved(before, "estimate")
    before = launches()
    est_out2, ms_warm = timed(lambda: est.estimate(host_batch))
    both_moved(before, "estimate (warm)")
    sub = np.arange(256)
    sub_batch = type(host_batch)(*[np.asarray(x)[sub] for x in host_batch])
    sub_cpu = graphs_to_device(sub_batch, "cpu")
    with torch.no_grad():
        raw = {m: forward_ensemble(models[m][0], sub_cpu, models[m][1]).numpy() for m in CLASSIFICATION_METRICS}
    check_answers("estimate", {m: v[sub] for m, v in est_out.items()}, cpu.estimate(sub_batch), raw)
    for m in est_out:
        if not np.array_equal(est_out[m], est_out2[m]):
            raise AssertionError(f"estimate {m}: two runs on the card differ")
        if est_out[m].shape != (B,) or not np.isfinite(est_out[m]).all():
            raise AssertionError(f"estimate {m}: bad shape or non-finite values")
    serve["estimate"] = {"graphs": int(B), "ms_first": ms_first, "ms": ms_warm, "corpus_s": t_corpus,
                         "featurize_s": t_featurize, "launches": dict(zip(("banked_mlp", "mp_update"), delta))}

    # score: 1024 sampled candidates on each of 8 distinct queries
    kinds = ("linear", "two_way", "three_way", "linear", "two_way", "three_way", "two_way", "linear")
    queries = [(workload.query(kind=k, name=f"q{i}"), workload.cluster(4 + i % 4)) for i, k in enumerate(kinds)]
    score_ms, n_cands, score_launches = [], [], []
    for i, (q, c) in enumerate(queries):
        a = sample_assignment_matrix(q, c, 1024, np.random.default_rng(i))
        before = launches()
        out, ms = timed(lambda: est.score(q, c, a))
        score_launches.append(both_moved(before, f"score q{i}"))
        score_ms.append(ms)
        n_cands.append(len(a))
        want = cpu.score(q, c, a)
        skel_c = graphs_to_device(build_graph_skeleton(q, c), "cpu")
        with torch.no_grad():
            raw = {m: gnn.apply_gnn_placed_members(models[m][0], skel_c,
                                                   torch.from_numpy(build_a_place_batch(q, c, a)),
                                                   query_static(q), models[m][1].gnn)[..., 0].numpy()
                   for m in CLASSIFICATION_METRICS}
        check_answers(f"score q{i}", out, want, raw)
    serve["score"] = {"queries": len(queries), "candidates": n_cands, "ms": score_ms,
                      "launches_banked_mlp_mp_update": score_launches}

    # optimize: the paper's placement search on 8 queries
    opt_ms, same = [], 0
    for i, (q, c) in enumerate(queries):
        before = launches()
        r, ms = timed(lambda: est.optimize(q, c, "latency_p", rng=np.random.default_rng(100 + i)))
        both_moved(before, f"optimize q{i}")
        opt_ms.append(ms)
        r_cpu = cpu.optimize(q, c, "latency_p", rng=np.random.default_rng(100 + i))
        if r.placement.assignment == r_cpu.placement.assignment:
            same += 1
        else:  # a near-tie: the card's pick must score as well on the CPU
            j = [p.assignment for p in r_cpu.candidates].index(r.placement.assignment)
            if not np.isclose(r_cpu.scores[j], r_cpu.predicted["latency_p"], rtol=SERVE_RTOL):
                raise AssertionError(f"optimize q{i}: the card picked a worse placement than the CPU")
    serve["optimize"] = {"queries": len(queries), "ms": opt_ms, "same_placement_as_cpu": same}
    torch.cuda.synchronize()
    main_launches = dict(zip(("banked_mlp", "mp_update"), launches()))
    serve["launches"] = main_launches
    serve["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    emit(serve)

    # -- 4. kernel summary (the representative case: the most work on the path) -------
    sources = {"banked_mlp": ("src/repro_torch/csrc/banked_mlp.cu", "src/repro/kernels/banked_mlp/kernel.py:53"),
               "mp_update": ("src/repro_torch/csrc/mp_update.cu", "src/repro/kernels/mp_update/kernel.py:64")}
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = max(mine, key=lambda r: r["flops"])
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": main_launches[name], "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": None, "case": rep["case"],
                        "shape": rep["shape"]})
    emit({"kernels": summary})

    # -- 5. the card, 6. status ---------------------------------------------------
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
