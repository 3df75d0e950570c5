#!/usr/bin/env python3
"""Drive the PyTorch port's serving, service and training paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py

Each phase prints one JSON line:
  build    nvcc build of every kernel (time; registers, spills and shared memory
           per kernel; the TF32 tensor-core MMAs in banked_mlp's, mp_update's and
           mp_sweep's SASS, which must be there, with no spills)
  kernels  each CUDA kernel against its plain PyTorch version at the shapes its
           path gives it (max abs error beside the tolerance; kernel, plain,
           bound and, where one PyTorch call computes the same function,
           library ms; for mp_sweep also per_level_ms, its levels as one
           mp_update launch each, held against the plain version too)
  serve    a full-width COSTREAM model (5 metrics x 3 members, hidden 64,
           use_pallas=True) answering estimate / score / optimize requests and
           the cross-query estimate_many / score_many, each answer held against
           the card's per-request answers and the same estimator on the CPU;
           every path runs with the launch counters set to 0 just before it and
           read just after, and fails if one of its kernels did not launch
  train    launch/train.py's main stage at full width (22,000 traces, 5 metrics x 3
           members, hidden 64, batch 512, exact banding, use_pallas=True), cut to 2
           epochs a metric: gradients through the kernels against the plain path
           on one batch (every leaf nonzero), each kernel's autograd.Function
           against autograd of its plain version (its backward timed), a step
           split into forward / backward / optimizer beside the plain path's, a
           profiled step, 20 steps with the kernels and with the plain path,
           validation loss below its value at init for every metric, and the
           exported bundle served on the card against the trained params
  service  that trained bundle behind PlacementService on the card (default
           policy: double-buffered drains) under the load harness's open-loop
           traffic (16 structures; 4-candidate requests on its metric set, which
           take merged drains; 256-candidate requests on all five metrics, which
           take per-structure drains; estimate requests of corpus graphs; p95 SLO
           250 ms): the launch half of a merged, a per-structure and an estimate
           group under set_sync_debug_mode("error"), the rate calibrated by a
           serial probe, a knee sweep over 0.25x to 4x of it, Poisson and bursty
           runs at 0.8x the knee with double buffering on and off (every answer
           against the card estimator's direct call, a sample against the CPU;
           each of the five COSTREAM kernels launched from the drains); breaker,
           NaN guard, swap_bundle and a shadow verdict; 20 profiled drains
  control  the seeded drift-and-failure fleet of docs/controller.md (8 queries, 30
           ticks, seed 7) re-planned through the card estimator beside the static
           fleet; its decisions equal to the same controller over the CPU
           estimator; SLO violations, migrations, re-plans, tick ms split into
           scoring and the rest
  lm       full-width RecurrentGemma-2B (26 layers, random bf16 weights from a
           seed) serving 4 requests: 2048-token prompts prefilled into the
           decode cache with serve_step, then 64 greedy decode steps; 18
           linear_scan launches per forward; the same weights and token stream
           with the plain scan on the card (logits against a stated bound); the
           reduced model in fp32 on the card against the CPU; prefill and
           decode times, the device split and peak memory
then the kernel summary line, the card's name and power limit, and the status
line.  Any failure exits nonzero; so does a machine without a CUDA device, or
a directory that holds this script and nothing else of the repository.
"""

import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The fastest route to fp32-accurate products on an H100 SXM: TF32 tensor
# cores at 495e12 FLOP/s with the 3xTF32 split (three products each), which
# holds TOL where TF32 alone does not.  The card's bound, so it is every
# kernel's operations rate, whether or not the kernel uses that route (the
# CUDA cores give 67e12).
PEAK_FP32_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-5  # rtol = atol for kernel against plain version
SERVE_RTOL = 1e-4
LM_RTOL = 1e-4  # reduced LM in fp32, card against CPU (TF32 off)
# The full-width kernel run against the plain-scan run: the kernel folds chunk
# maps into carries, so its scan agrees with the plain loop within TOL, not
# bitwise, and the bf16 layers after it may round a value the other way; the
# bound allows one bf16 rounding (2**-8 relative) of the largest logit.
LM_SCAN_REL = 2.0**-8
# The train phase runs the same first steps of an epoch with the kernels and
# with the plain path from one start.  A step's loss first differs by the
# kernels' forward error (at most 2.6e-6 on states of order one, about 1e-6 of
# the loss); Adam then turns a gradient difference into a parameter difference
# of at most 2 lr_t (lr_t <= 1.5e-3) on the few components whose gradient
# changes sign, which moves the loss by a small fraction of those components'
# share; 20 steps stay far inside 1e-3 relative, the bound (the loosest
# allowed).
TRAJ_REL = 1e-3
# What each path is asked, and how often each kernel is timed.  Smaller values
# (with DEVICE = "cpu" and the counters stubbed) give a quick dry run of the
# script's control flow; the numbers it prints are then meaningless.
SIZES = {"traces": 4096, "many_batch": 512, "drain_structures": 16, "drain_candidates": 256,
         "score_candidates": 1024, "placed_candidates": 256, "timing_reps": 20,
         "train_traces": 22_000, "train_epochs": 2, "train_trajectory": 20,
         "lm_reduced": False, "lm_batch": 4, "lm_prompt": 2048, "lm_decode": 64,
         "svc_structures": 16, "svc_small": 192, "svc_small_cands": 4, "svc_large": 192, "svc_large_cands": 256,
         "svc_estimates": 16, "svc_estimate_graphs": 32, "svc_slo_ms": 250.0, "svc_knee": (0.25, 0.5, 1.0, 2.0, 4.0),
         "svc_profile_drains": 20, "ctl_queries": 8, "ctl_ticks": 30}
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    """Least time for the work on this card: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_mmas(library: str):
    """TF32 ``HMMA`` instructions per kernel in a built library's SASS
    (``cuobjdump -sass``), keyed by the kernel's mangled name."""
    cuobjdump = Path(shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line and "TF32" in line:
            counts[name] += 1
    return counts


#: The service phase's traffic, after the project's load harness
#: (benchmarks/load_harness.py, docs/load_harness.md): its 16 structures and
#: 4-candidate score requests on its metric set (dispatch-bound: merged
#: drains), requests of 256 candidates on all five metrics (compute-bound:
#: per-structure drains) and estimate requests of corpus graphs, a p95 SLO of
#: 250 ms, the rate calibrated by a closed-loop serial probe, a knee sweep
#: over 0.25x to 4x of it, then runs at 0.8x the knee.
HARNESS_METRICS = ("latency_p", "success", "backpressure")
CONTROL_SLO_MS = 100.0  # the scenario's e2e latency bound per query (control/scenario.py fleet_queries)


def service_phase(bundle, reload_bundle, counted, device_split, card):
    """``PlacementService`` over the card estimator of a trained bundle, under
    open-loop load; every answer held against the estimator's direct call."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.core import gnn
    from repro_torch.core.graph import batch_graphs, build_a_place_batch, build_graph, build_graph_skeleton, query_static
    from repro_torch.core.model import ALL_METRICS, REGRESSION_METRICS, forward_ensemble, init_cost_model
    from repro_torch.dsps import WorkloadGenerator
    from repro_torch.placement.enumerate import sample_assignment_matrix
    from repro_torch.serve import chaos
    from repro_torch.serve.estimator import CostEstimator, NonFiniteEstimate, graphs_to_device
    from repro_torch.serve.lifecycle import BundleSwapper
    from repro_torch.serve.load import bursty_arrivals, find_knee, poisson_arrivals, run_open_loop
    from repro_torch.serve.policy import DispatchPolicy
    from repro_torch.serve.service import PlacementService

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    est = CostEstimator.from_bundle(bundle, device=DEVICE)
    cpu = CostEstimator.from_bundle(bundle, device="cpu")
    S, slo_s = SIZES["svc_structures"], SIZES["svc_slo_ms"] / 1e3
    out = {"phase": "service", "card": card,
           "bundle": {"metrics": list(bundle.metrics), "members": bundle.config(bundle.metrics[0]).n_ensemble,
                      "hidden": bundle.config(bundle.metrics[0]).gnn.hidden},
           "policy": {"default": True, "double_buffer": est.policy.resolved_double_buffer(est.device)}}

    # -- the traffic ----------------------------------------------------------------
    gen = WorkloadGenerator(seed=0)
    kinds = ("linear", "two_way", "three_way")
    structures = [(gen.query(kind=kinds[i % 3], name=f"load{i}"), gen.cluster(3 + i % 6)) for i in range(S)]
    rng = np.random.default_rng(0)

    def cands(q, c, n):
        a = sample_assignment_matrix(q, c, n, rng)
        return a[np.arange(n) % len(a)]  # exactly n rows, repeating where the space is small

    reqs = [("score", (*structures[i % S], cands(*structures[i % S], SIZES["svc_small_cands"])), HARNESS_METRICS)
            for i in range(SIZES["svc_small"])]
    reqs += [("score", (*structures[i % S], cands(*structures[i % S], SIZES["svc_large_cands"])), ALL_METRICS)
             for i in range(SIZES["svc_large"])]
    per = SIZES["svc_estimate_graphs"]
    traces = WorkloadGenerator(seed=5).corpus(per * SIZES["svc_estimates"])
    reqs += [("estimate", batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces[j:j + per]]),
              ALL_METRICS) for j in range(0, len(traces), per)]
    reqs = [reqs[i] for i in np.random.default_rng(1).permutation(len(reqs))]
    out["traffic"] = {"structures": S, "requests": len(reqs), "small": [SIZES["svc_small"], SIZES["svc_small_cands"]],
                      "large": [SIZES["svc_large"], SIZES["svc_large_cands"]],
                      "estimates": [SIZES["svc_estimates"], per], "slo_ms": SIZES["svc_slo_ms"]}

    def direct(r, e):
        kind, p, ms = r
        return e.score(*p, ms) if kind == "score" else e.estimate(p, ms)

    def submit(svc, r):
        kind, p, ms = r
        return svc.submit_score(*p, ms) if kind == "score" else svc.submit_estimate(p, ms)

    def logits(r, e):
        """Raw classification logits (metric -> (E, B)) of a request on ``e``."""
        kind, p, ms = r
        with torch.no_grad():
            if kind == "estimate":
                g = graphs_to_device(p, e.device)
                return {m: forward_ensemble(e._params_for(m), g, e.config(m)).cpu().numpy() for m in ms}
            q, c, a = p
            skel = graphs_to_device(build_graph_skeleton(q, c), e.device)
            ap = torch.as_tensor(build_a_place_batch(q, c, a), device=e.device)
            return {m: gnn.apply_gnn_placed_members(e._params_for(m), skel, ap, query_static(q), e.config(m).gnn)[..., 0]
                    .cpu().numpy() for m in ms}

    def agree(what, got, want, r, e):
        """Regression within SERVE_RTOL (absolute term 1e-6); votes equal
        wherever every member's logit is clear of 0 by 1e-3."""
        if isinstance(got, BaseException) or getattr(got, "degraded", False):
            raise AssertionError(f"{what}: {got!r} where an answer was due")
        for m in want:
            a, b = np.asarray(got[m]), np.asarray(want[m])
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{what} {m}: shape {a.shape} against {b.shape}, or non-finite values")
            if m in REGRESSION_METRICS:
                if not np.allclose(a, b, rtol=SERVE_RTOL, atol=1e-6):
                    raise AssertionError(f"{what} {m}: max rel err "
                                         f"{float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))}")
            elif not np.array_equal(a, b):
                clear = (np.abs(logits(r, e)[m]) > 1e-3).all(axis=0)
                if not np.array_equal(a[clear], b[clear]):
                    raise AssertionError(f"{what} {m}: votes differ away from the threshold")

    t0 = time.perf_counter()
    want = [direct(r, est) for r in reqs]  # the card estimator's direct per-request answers
    out["direct_s"] = time.perf_counter() - t0

    # -- the launch half waits for nothing on the host ------------------------------------
    probe = PlacementService(est, auto_start=False)
    out["warm_forwards"] = probe.warm(structures, max_cands=SIZES["svc_small_cands"])
    small = [i for i, r in enumerate(reqs) if r[2] == HARNESS_METRICS]
    one_each = [next(i for i in small if reqs[i][1][0] is q) for q, _ in structures]
    large = [i for i, r in enumerate(reqs) if r[0] == "score" and r[2] == ALL_METRICS][:2]
    ests = [i for i, r in enumerate(reqs) if r[0] == "estimate"][:2]
    launch_half = {}
    for label, idx, launch, n_cross in (("merged score group", one_each, probe._launch_scores, len(one_each)),
                                        ("per-structure score group", large, probe._launch_scores, 0),
                                        ("estimate group", ests, probe._launch_estimates, 0)):
        for i in idx:
            submit(probe, reqs[i])
        popped = list(probe._queue)
        probe._queue.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            finalize = launch(popped)
        except RuntimeError as e:
            raise AssertionError(f"service launch half, {label}: a host-device sync ({e})") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms = (time.perf_counter() - t) * 1e3
        answers, n_fwd, got_cross = finalize()
        if probe.stats.n_retries or got_cross != n_cross:
            raise AssertionError(f"service launch half, {label}: {probe.stats.n_retries} retries (a launch that "
                                 f"failed, e.g. on a sync), {got_cross} cross-query requests, want {n_cross}")
        for i, a in zip(idx, answers):
            agree(f"launch-half {label} request {i}", a, want[i], reqs[i], est)
        launch_half[label] = {"requests": len(idx), "launch_ms": ms, "forwards": n_fwd, "syncs": 0}
    probe.close()
    out["launch_half_sync_free"] = launch_half

    # -- the rate, the knee, the runs (counted: the service's own drains) -----------------
    cgen = WorkloadGenerator(seed=991)  # a throw-away structure, as the harness calibrates
    cq, cc = cgen.query(kind="linear", name="calib"), cgen.cluster(4)
    ca = cands(cq, cc, SIZES["svc_small_cands"])
    est.score(cq, cc, ca, HARNESS_METRICS)
    t0 = time.perf_counter()
    for _ in range(24):
        est.score(cq, cc, ca, HARNESS_METRICS)
    rate = 24 / (time.perf_counter() - t0)

    def instrument(svc):
        split = {"launch": [], "finalize": []}
        for name, key in (("_launch_group", "launch"), ("_finalize_group", "finalize")):
            orig = getattr(svc, name)

            def timed(*a, _orig=orig, _key=key):
                t = time.perf_counter()
                r = _orig(*a)
                split[_key].append((time.perf_counter() - t) * 1e3)
                return r

            setattr(svc, name, timed)
        return split

    def run(svc, r, kind, seed):
        n = len(reqs)
        sched = (poisson_arrivals(r, n, seed=seed) if kind == "poisson"
                 else bursty_arrivals(r, n, seed=seed, burst_factor=4.0, burst_fraction=0.25))
        futs = [None] * n

        def fire(i):
            def f():
                futs[i] = submit(svc, reqs[i])
                return futs[i]
            return f

        svc.stats.reset()
        return run_open_loop(svc, [fire(i) for i in range(n)], sched, slo_s=slo_s, timeout_s=300), futs

    def fresh(db):
        """A warmed service with one closed-loop pass behind it (every request
        shape seen once), so each run starts from the same history: merged-mix
        admissions (``max_merged_mixes``) are spent per service."""
        svc = PlacementService(est, double_buffer=db, warmup=structures, warmup_cands=SIZES["svc_small_cands"])
        for f in [submit(svc, r) for r in reqs]:
            f.result(timeout=300)
        return svc, instrument(svc)

    def load_runs():
        sweep = {}
        sweeper, _ = fresh(True)

        def at_rate(r):
            rep, futs = run(sweeper, r, "poisson", 7)
            sweep[r] = (rep, futs)
            return rep

        knee, points = find_knee(at_rate, [rate * f for f in SIZES["svc_knee"]], slo_s)
        op = 0.8 * (knee if knee is not None else rate * min(SIZES["svc_knee"]))
        runs = {}
        for kind in ("poisson", "bursty"):
            for db in (True, False):
                svc, split = fresh(db)
                mixes = svc._n_runtime_mixes
                runs[(kind, db)] = (*run(svc, op, kind, 11), split, (mixes, svc._n_runtime_mixes - mixes))
                svc.close()
        return knee, points, op, sweep, runs, sweeper

    (knee, points, op, sweep, runs, sweeper), got = counted("service", load_runs,
                                                   ("banked_mlp", "mp_update", "mp_sweep", "gather_sum", "segment_sum"),
                                                   ("linear_scan",))
    out["launches"] = got
    out["calibrated_serial_rps"] = rate
    out["knee_rps"] = knee
    out["knee_sweep"] = [{"rps": p.rate, "p95_ms": p.p95_s * 1e3, "slo_violation_rate": p.slo_violation_rate}
                         for p in points]
    out["operating_rps"] = op
    checked = 0
    for futs in [f for _, f in sweep.values()] + [r[1] for r in runs.values()]:
        for i, f in enumerate(futs):
            agree(f"service request {i}", f.result(timeout=60), want[i], reqs[i], est)
            checked += 1
    out["answers_checked_against_direct"] = checked
    result = {}
    for (kind, db), (rep, _, split, mixes) in runs.items():
        st = rep.stats
        result[f"{kind}_{'double_buffer' if db else 'serial'}"] = {
            "offered_rps": rep.offered_rate, "achieved_rps": rep.achieved_rate,
            "p50_ms": rep.p50_s * 1e3, "p95_ms": rep.p95_s * 1e3, "p99_ms": rep.p99_s * 1e3,
            "slo_violation_rate": rep.slo_violation_rate, "answered": rep.n_answered, "rejected": rep.n_rejected,
            "failed": rep.n_failed, "drains": st.n_batches, "mean_drain": st.n_drained / max(st.n_batches, 1),
            "max_drain": st.max_drain, "forwards": st.n_forwards, "cross_query": st.n_cross_query,
            "mean_queue_wait_ms": st.queue_wait_s / max(st.n_drained, 1) * 1e3,
            "runtime_mixes_admitted_before_and_during": mixes,
            "host_ms_per_group": {k: {"groups": len(v), "mean": float(np.mean(v)), "p50": float(np.median(v)),
                                      "p95": float(np.percentile(v, 95))} for k, v in split.items()}}
        if rep.n_answered != rep.n_requests:
            raise AssertionError(f"service {kind} double_buffer={db}: {rep.n_answered} of {rep.n_requests} answered")
    out["runs"] = result

    # a sample held against the same bundle on the CPU
    sample = small[:6] + [i for i, r in enumerate(reqs) if r[0] == "score" and r[2] == ALL_METRICS][:3] + ests[:2]
    futs = runs[("poisson", True)][1]
    for i in sample:
        agree(f"service request {i} against the CPU", futs[i].result(), direct(reqs[i], cpu), reqs[i], cpu)
    out["answers_checked_against_cpu"] = len(sample)

    # 20 warm drains under the profiler
    svc = sweeper
    burst = [reqs[i] for i in one_each]
    n0 = svc.stats.n_batches

    def twenty():
        for _ in range(SIZES["svc_profile_drains"]):
            for f in [submit(svc, r) for r in burst]:
                f.result(timeout=60)

    out["profile"] = {**device_split(twenty), "drains": svc.stats.n_batches - n0, "requests_a_burst": len(burst)}
    svc.close()

    # -- faults: breaker, NaN guard, swap, shadow ----------------------------------
    # per-structure drains: a forward that raises is retried, then answered
    # from the fallback; two such failures open the breaker
    fast = DispatchPolicy(breaker_window=8, breaker_min_samples=2, retry_backoff_s=0.001)
    bsvc = PlacementService(est, policy=fast, cross_query=False)
    fault = chaos.RaiseFault(p=1.0, seed=0)
    est.add_hook(fault)
    try:
        first = [bsvc.submit_score(*reqs[i][1], reqs[i][2]).result(timeout=60) for i in small[:2]]
        opened = bsvc.breaker.state
        short = bsvc.submit_score(*reqs[small[4]][1], reqs[small[4]][2]).result(timeout=60)
    finally:
        est.remove_hook(fault)
    if not all(getattr(a, "degraded", False) and a.cause is not None for a in first) or opened != "open":
        raise AssertionError(f"service breaker: state {opened} after raising forwards; answers {first}")
    if not getattr(short, "degraded", False) or short.cause is not None:
        raise AssertionError("service breaker: an open breaker must answer from the fallback without the estimator")
    time.sleep(fast.breaker_cooldown_s)
    healed = bsvc.submit_score(*reqs[small[5]][1], reqs[small[5]][2]).result(timeout=60)
    agree("service request after the breaker closed", healed, want[small[5]], reqs[small[5]], est)
    breaker = {"state_after_faults": opened, "state_after_cooldown": bsvc.breaker.state, "opens": bsvc.breaker.n_opens,
               "degraded": bsvc.stats.n_degraded, "retries": bsvc.stats.n_retries, "failed": bsvc.stats.n_failed}
    bsvc.close()
    if breaker["state_after_cooldown"] != "closed" or breaker["failed"]:
        raise AssertionError(f"service breaker: {breaker}")
    out["breaker"] = breaker

    nsvc = PlacementService(est, cross_query=False)
    nan = chaos.NaNFault(p=1.0, seed=0)
    est.add_hook(nan)
    try:
        scored = nsvc.submit_score(*reqs[small[0]][1], reqs[small[0]][2]).result(timeout=60)
        try:
            nsvc.submit_estimate(reqs[ests[0]][1], reqs[ests[0]][2]).result(timeout=60)
            raise AssertionError("service NaN guard: a poisoned estimate was delivered")
        except NonFiniteEstimate:
            pass
    finally:
        est.remove_hook(nan)
    if not (getattr(scored, "degraded", False) and isinstance(scored.cause, NonFiniteEstimate)):
        raise AssertionError("service NaN guard: a poisoned score was not caught")
    out["nan_guard"] = {"nonfinite": nsvc.stats.n_nonfinite, "injected": nan.n_injected, "degraded": nsvc.stats.n_degraded}
    nsvc.close()

    ssvc = PlacementService(est)
    pick = small[:3] + large + ests
    before = [submit(ssvc, reqs[i]).result(timeout=60) for i in pick]
    old = ssvc.swap_bundle(reload_bundle(), wait=True)
    after = [submit(ssvc, reqs[i]).result(timeout=60) for i in pick]
    if old is not est or ssvc.estimator is est or not all(
            np.array_equal(a[m], b[m]) for a, b in zip(before, after) for m in a):
        raise AssertionError("service swap: answers after swapping in the same bundle from disk differ")
    out["swap"] = {"requests": len(pick), "bitwise_equal": True, "swaps": ssvc.stats.n_swaps}
    ssvc.close()

    gen1 = torch.Generator().manual_seed(1)
    rand = CostEstimator({m: (init_cost_model(gen1, bundle.config(m)), bundle.config(m)) for m in bundle.metrics},
                         device=DEVICE)
    shsvc = PlacementService(est, policy=DispatchPolicy(shadow_fraction=1.0))
    swapper = BundleSwapper(shsvc, seed=0)
    swapper.start_shadow(rand)
    for f in [submit(shsvc, reqs[i]) for i in small[:32]]:
        f.result(timeout=60)
    swapper.drain_shadow(timeout=120)
    verdict = swapper.verdict()
    swapper.close()
    shsvc.close()
    out["shadow_seed1_random_candidate"] = dc.asdict(verdict)
    if verdict.n_mirrored == 0 or verdict.n_candidate_errors:
        raise AssertionError(f"service shadow: {verdict}")
    out["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return est, cpu


def control_phase(est, cpu, counted, card):
    """The seeded drift-and-failure fleet of docs/controller.md, re-planned
    through the card estimator beside the static fleet; decisions held
    against the same controller over the CPU estimator."""
    import numpy as np

    from repro_torch.control import FleetRuntime, PlacementController, build_scenario, run_static
    from repro_torch.serve.policy import active_policy

    n_q, n_ticks = SIZES["ctl_queries"], SIZES["ctl_ticks"]
    t0 = time.perf_counter()
    fleet, cluster, events = build_scenario(n_q, n_ticks, seed=7)
    out = {"phase": "control", "card": card, "queries": n_q, "ticks": n_ticks, "seed": 7,
           "scenario_s": time.perf_counter() - t0, "slo_ms_per_query": CONTROL_SLO_MS}
    tick_s = active_policy().controller_tick_s

    def runtime(snaps):
        rt = FleetRuntime(fleet, cluster, events, seed=1, tick_s=tick_s)
        tick = rt.tick

        def recorded():
            snaps.append(tick())
            return snaps[-1]

        rt.tick = recorded
        return rt

    def violations(snaps):
        return sum(q.cost_ms > CONTROL_SLO_MS for s in snaps for q in s.queries.values())

    def drive(e):
        snaps = []
        ctl = PlacementController(runtime(snaps), estimator=e, seed=0)
        score_s = []
        score_all = ctl.replanner._score_all

        def timed(*a):
            t = time.perf_counter()
            r = score_all(*a)
            score_s.append(time.perf_counter() - t)
            return r

        ctl.replanner._score_all = timed
        tick_ms, scoring_ms = [], []
        for _ in range(n_ticks):
            n = len(score_s)
            t = time.perf_counter()
            ctl.step()
            tick_ms.append((time.perf_counter() - t) * 1e3)
            scoring_ms.append(sum(score_s[n:]) * 1e3)
        return ctl.report(), snaps, tick_ms, scoring_ms

    cold = drive(est)
    (warm, snaps, tick_ms, scoring_ms), got = counted("control", lambda: drive(est), ("banked_mlp",), ("linear_scan",))
    on_cpu = drive(cpu)[0]
    static_snaps = []
    static = run_static(runtime(static_snaps), n_ticks)
    flips = []
    for r_card, r_cpu in zip(warm.records, on_cpu.records):
        for a, b in zip(r_card.decisions, r_cpu.decisions):
            ka, kb = a.to_dict(), b.to_dict()
            floats = ("predicted_cost", "current_cost", "gain")
            if {k: v for k, v in ka.items() if k not in floats} != {k: v for k, v in kb.items() if k not in floats}:
                flips.append({"tick": r_card.tick, "query_id": a.query_id, "card": ka, "cpu": kb,
                              "margin": {"card_gain": a.gain, "cpu_gain": b.gain}})
        if len(r_card.decisions) != len(r_cpu.decisions):
            flips.append({"tick": r_card.tick, "decisions": [len(r_card.decisions), len(r_cpu.decisions)]})
    rest = [t - s for t, s in zip(tick_ms, scoring_ms)]
    out.update({
        "controller": {**warm.to_dict(), "slo_violations": violations(snaps)},
        "static": {**static.to_dict(), "slo_violations": violations(static_snaps)},
        "cpu_estimator": on_cpu.to_dict(),
        "cold_replays_warm": cold[0].decision_log() == warm.decision_log(),
        "tick_ms": {"mean": float(np.mean(tick_ms)), "p50": float(np.median(tick_ms)), "max": float(np.max(tick_ms))},
        "tick_scoring_ms": {"mean": float(np.mean(scoring_ms)), "max": float(np.max(scoring_ms))},
        "tick_rest_ms": {"mean": float(np.mean(rest)), "max": float(np.max(rest))},
        "launches": got, "decision_flips_card_vs_cpu": flips, "seconds": time.perf_counter() - t0,
    })
    emit(out)
    if flips:
        raise AssertionError(f"control: {len(flips)} re-plan decision(s) differ between the card and the CPU")
    if not out["cold_replays_warm"]:
        raise AssertionError("control: a warm replay on the card changed the decision log")


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
        JointGraph,
        batch_banding,
        batch_graphs,
        build_a_place_batch,
        build_graph,
        build_graph_skeleton,
        exact_banding,
        query_static,
        skeleton_cache_key,
    )
    from repro_torch.core.model import (
        ALL_METRICS,
        CLASSIFICATION_METRICS,
        REGRESSION_METRICS,
        CostModelConfig,
        ensemble_loss,
        forward_ensemble,
        init_cost_model,
        label_array,
    )
    from repro_torch.dsps import WorkloadGenerator
    from repro_torch.kernels import _build
    from repro_torch.kernels.banked_mlp import ops as bank_ops
    from repro_torch.kernels.banked_mlp.ref import banked_mlp_slotted_ref
    from repro_torch.kernels.mp_sweep import ops as sweep_ops
    from repro_torch.kernels.mp_sweep.ref import mp_sweep_ref
    from repro_torch.kernels.mp_update import ops as mp_ops
    from repro_torch.kernels.mp_update.ref import mp_update_ref
    from repro_torch.kernels.rglru import ops as scan_ops
    from repro_torch.kernels.rglru.ref import linear_scan_ref
    from repro_torch.kernels.seg_gather import ops as seg_ops
    from repro_torch.kernels.seg_gather.ref import gather_sum_ref, segment_sum_ref
    from repro_torch.placement.enumerate import sample_assignment_matrix
    from repro_torch.launch import artifacts
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.bundle import corpus_fingerprint
    from repro_torch.serve.estimator import CostEstimator, graphs_to_device
    from repro_torch.serve.stacking import _ensemble_vote, stack_metric_models
    from repro_torch.training import batching, loop, optim
    from repro_torch.training.compression import ef_init
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.params import count_params, materialize
    from repro_torch.models.steps import make_serve_step
    from repro_torch.models.transformer import forward as lm_forward, model_cache_defs, model_defs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- 1. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    mma = {n: tensor_core_mmas(built[n]["path"]) for n in ("banked_mlp", "mp_update", "mp_sweep")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": b["seconds"], "ptxas": b["ptxas"]} for n, b in built.items()},
          "tf32_mma_in_sass": mma})
    for n, per_kernel in mma.items():
        kernels = {k: v for k, v in built[n]["ptxas"].items() if k.startswith(n + "_kernel")}
        if not kernels or any(v.get("spill_store_bytes", 0) for v in kernels.values()):
            raise AssertionError(f"{n}: ptxas reports spills or no kernel: {kernels}")
        if not per_kernel or not all(per_kernel.values()):
            raise AssertionError(f"{n}: a kernel issues no TF32 tensor-core MMA: {per_kernel}")

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
    traces = workload.corpus(SIZES["traces"])
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_batch = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    t_featurize = time.perf_counter() - t0
    g = graphs_to_device(host_batch, dev)
    B, N = host_batch.op_x.shape[:2]
    W = host_batch.hw_x.shape[1]
    # estimate_many's request: the same 4096 graphs as 8 batches of 512
    mb = SIZES["many_batch"]
    many_batches = [JointGraph(*[np.asarray(x)[i : i + mb] for x in host_batch]) for i in range(0, B, mb)]
    # score_many's request: 16 distinct (query, cluster) structures, up to 256 candidates each
    drain_gen = WorkloadGenerator(seed=1)
    drain = []
    for i in range(SIZES["drain_structures"]):
        q = drain_gen.query(kind=("linear", "two_way", "three_way")[i % 3], name=f"d{i}")
        c = drain_gen.cluster(3 + i % 6)
        drain.append((q, c, sample_assignment_matrix(q, c, SIZES["drain_candidates"], np.random.default_rng(200 + i))))
    if len({skeleton_cache_key(q, c) for q, c, _ in drain}) != len(drain):
        raise AssertionError("score_many drain: the structures are not distinct")

    # -- 2. kernels against their plain versions -------------------------------------
    def cuda_ms(fn, reps=SIZES["timing_reps"], warmup=3):
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

    def compare(name, case, kernel, plain, flops, nbytes, library=None, yardsticks=None):
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
        lib_err = None if library is None else float((library() - want).abs().max())
        b_ms, b_by = bound(flops, nbytes)
        row = {"phase": "kernels", "kernel": name, "case": case, "shape": list(got.shape),
               "max_abs_err": err, "tol": TOL, "ok": ok, "deterministic": bool(torch.equal(got, again)),
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if library is None else cuda_ms(library), "library_max_abs_err": lib_err,
               "flops": flops, "bytes": nbytes}
        stick_ok = {}
        for k, fn in (yardsticks or {}).items():  # another route to the same function, timed beside it
            out = fn()
            row[f"{k}_max_abs_err"] = float((out - want).abs().max())
            stick_ok[k] = bool(torch.allclose(out, want, rtol=TOL, atol=TOL))
            row[f"{k}_ms"] = cuda_ms(fn)
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {case}: kernel disagrees with its plain version (max abs err {err})")
        for k, good in stick_ok.items():
            if not good:
                raise AssertionError(f"{name} {case}: {k} disagrees with the plain version "
                                     f"(max abs err {row[f'{k}_max_abs_err']})")
        if lib_err is not None and lib_err > TOL * (1 + float(want.abs().max())):
            raise AssertionError(f"{name} {case}: the library call disagrees with the plain version ({lib_err})")
        if not row["deterministic"]:
            raise AssertionError(f"{name} {case}: two launches on the same inputs differ")
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
    x_hw = torch.randn((E, B, W, 2 * H), generator=rng).to(dev)
    rows.append(bank_case("hw_upd, F=128, T=1", hw_bank(stacked["hw_upd"]), x_hw, ((0, 0, W),), False))
    del x_hw

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
    h_trim = torch.randn((E, SIZES["placed_candidates"], len(order), H), generator=rng).to(dev)
    rows.append(mp_case(f"placed level d={d_lvl}, span {span}, parent_rows {p_rows}, shared fields",
                        h_trim, a_trim, depth_trim, ones, d_lvl, lvl_ranges, span, p_rows))
    h_pad = torch.randn((E, SIZES["placed_candidates"], N, H), generator=rng).to(dev)
    rows.append(mp_case("full width, d=1, shared (N, N) skeleton", h_pad, skel.a_flow, skel.op_depth,
                        skel.op_mask, 1, SLOT_RANGES))
    del h_full, h_trim, h_pad

    # mp_sweep at estimate_many's shapes: the 4096 graphs on their trimmed
    # exact-banding layout, every level of the table in one launch
    band = exact_banding(host_batch)
    keep = torch.tensor(band.rows, device=dev)
    a_b = g.a_flow.index_select(1, keep).index_select(2, keep).contiguous()
    depth_b = g.op_depth.index_select(1, keep).contiguous()
    mask_b = g.op_mask.index_select(1, keep).contiguous()
    sweep_levels = gnn._banded_plan(band, band.ranges).levels
    h_b = torch.randn((E, B, len(band.rows), H), generator=rng).to(dev)
    _, _, _, H1 = stacked["op_upd"]["layers"][0]["w"].shape
    sweep_flops = 0.0
    for d, (s, e), _, p in sweep_levels:  # the rows this run's levels select
        n_sel = int(((depth_b[:, s:e] == d) & (mask_b[:, s:e] > 0)).sum())
        sweep_flops += 2.0 * E * n_sel * (p * H + 2 * H * H1 + H1 * H)
    sweep_bytes = (4.0 * (2 * h_b.numel() + E * 5 * (2 * H * H1 + H1 + H1 * H + H))
                   + 4.0 * (a_b.numel() + depth_b.numel() + mask_b.numel()))

    def per_level():  # the same levels as one mp_update launch each (the banded plan)
        hh = h_b
        for d, span, ranges, p in sweep_levels:
            hh = mp_ops.mp_update(stacked["op_upd"], hh, a_b, depth_b, mask_b, d, ranges, row_span=span, parent_rows=p)
        return hh

    rows.append(compare(
        "mp_sweep", f"estimate_many: {B} graphs, {len(band.rows)} trimmed rows, {len(sweep_levels)} levels "
        f"{[(d, list(sp), p) for d, sp, _, p in sweep_levels]}",
        lambda: sweep_ops.mp_sweep(stacked["op_upd"], h_b, a_b, depth_b, mask_b, sweep_levels),
        lambda: mp_sweep_ref(stacked["op_upd"], h_b, a_b, depth_b, mask_b, sweep_levels),
        sweep_flops, sweep_bytes, yardsticks={"per_level": per_level}))
    del h_b

    # gather_sum / segment_sum at score_many's shapes: the 16-structure drain's
    # rows (score_many runs them as one chunk, unpadded) on its trimmed
    # layout, with the engine's own index tables
    skels16 = batch_graphs([build_graph_skeleton(q, c) for q, c, _ in drain])
    band16 = exact_banding(skels16)
    keep16 = torch.tensor(band16.rows if band16.rows is not None else range(N), device=dev)
    sk = graphs_to_device(skels16, dev)
    ids16 = torch.as_tensor(np.concatenate([np.full(len(a), i) for i, (_, _, a) in enumerate(drain)]), device=dev)
    ap16 = torch.as_tensor(np.concatenate([build_a_place_batch(q, c, a) for q, c, a in drain]), device=dev)
    ap16 = ap16.index_select(1, keep16)
    host16 = ap16.argmax(dim=-1)
    placed16 = ap16.amax(dim=-1)[..., None]
    flow_in = sk.a_flow.index_select(1, keep16).index_select(2, keep16).transpose(-1, -2)
    pidx = torch.argsort(-flow_in, dim=-1, stable=True)[..., :2]
    row_pidx, row_pmask = pidx[ids16], torch.gather(flow_in, -1, pidx)[ids16]
    R16, n16 = ap16.shape[0], ap16.shape[1]

    def gather_case(case, hh, idx, w):
        """Bound: the FMAs of the nonzero weights, and the bytes of the h rows
        those weights reference (each distinct (graph, row) once per member),
        the output, and the int64 index and f32 weight tables.  Library:
        ``embedding_bag`` over h flattened to rows, its index table built
        here, outside the timing."""
        Eg, Bg, Ng, Hg = hh.shape
        Rg, Pg = idx.shape[1], idx.shape[2]
        graph = torch.arange(Bg, device=dev)[:, None, None]
        live = w != 0
        n_rows = int(torch.unique((graph * Ng + idx)[live]).numel())
        member = torch.arange(Eg, device=dev)[:, None, None, None]
        flat_idx = ((member * Bg + graph) * Ng + idx).reshape(-1, Pg)
        flat_w = w.expand(Eg, *w.shape).reshape(-1, Pg)
        h_rows = hh.reshape(-1, Hg)
        return compare("gather_sum", case, lambda: seg_ops.gather_sum(hh, idx, w),
                       lambda: gather_sum_ref(hh, idx, w), 2.0 * Eg * int(live.sum()) * Hg,
                       4.0 * Eg * (n_rows + Bg * Rg) * Hg + 12.0 * Bg * Rg * Pg,
                       library=lambda: torch.nn.functional.embedding_bag(
                           flat_idx, h_rows, mode="sum", per_sample_weights=flat_w).view(Eg, Bg, Rg, Hg))

    h_hw16 = torch.randn((E, R16, W, H), generator=rng).to(dev)
    rows.append(gather_case(f"stage 2, P=1: {R16} rows of {len(drain)} structures", h_hw16, host16[..., None], placed16))
    d16, (s16, e16), _, _ = max(gnn._banded_plan(band16, band16.ranges or SLOT_RANGES).levels,
                                key=lambda lv: lv[1][1] - lv[1][0])
    h16 = torch.randn((E, R16, n16, H), generator=rng).to(dev)
    rows.append(gather_case(f"stage 3 level d={d16}, span {(s16, e16)}, P=2, column slice",
                            h16, row_pidx[:, s16:e16], row_pmask[:, s16:e16]))
    x16 = torch.randn((E, R16, n16, H), generator=rng).to(dev)
    seg_out = torch.empty((E, R16, W, H), device=dev)
    seg_index = host16[..., None].expand(x16.shape)
    rows.append(compare("segment_sum", f"stage 1: {R16} rows x {n16} operators -> {W} hosts",
                        lambda: seg_ops.segment_sum(x16, host16, W), lambda: segment_sum_ref(x16, host16, W),
                        1.0 * x16.numel(), 4.0 * (x16.numel() + seg_out.numel()) + 8.0 * host16.numel(),
                        library=lambda: seg_out.zero_().scatter_add_(2, seg_index, x16)))
    del h_hw16, h16, x16, seg_out

    # linear_scan at the RG-LRU block's shapes in the lm phase: the prefill
    # (batch, prompt, rnn_width), a decode step with h0 as the slice of a
    # stacked (groups, batch, width) cache that the model hands over, and a
    # ragged shape with h0 a strided column slice
    lm_cfg = get_config("recurrentgemma-2b")
    if SIZES["lm_reduced"]:
        lm_cfg = reduced(lm_cfg)
    width, lm_b = lm_cfg.rnn_width, SIZES["lm_batch"]

    def scan_case(case, Bs, Ts, Ds, h0):
        a = torch.rand((Bs, Ts, Ds), generator=rng).to(dev)
        x = torch.randn((Bs, Ts, Ds), generator=rng).to(dev)
        n = Bs * Ts * Ds
        return compare("linear_scan", case, lambda: scan_ops.linear_scan(a, x, h0),
                       lambda: linear_scan_ref(a, x, h0), 2.0 * n, 4.0 * (2 * n + Bs * Ds) + 4.0 * n)

    stack_h = torch.randn((lm_cfg.n_groups, lm_b, width), generator=rng).to(dev)
    rows.append(scan_case(f"prefill ({lm_b}, {SIZES['lm_prompt']}, {width})", lm_b, SIZES["lm_prompt"], width,
                          torch.randn((lm_b, width), generator=rng).to(dev)))
    last = lm_cfg.n_groups - 1
    rows.append(scan_case(f"decode ({lm_b}, 1, {width}), h0 = stacked cache [{last}]", lm_b, 1, width, stack_h[last]))
    wide = torch.randn((3, 3, 107), generator=rng).to(dev)
    rows.append(scan_case("ragged (3, 37, 100), h0 a strided column slice", 3, 37, 100, wide[1, :, 5:105]))
    del stack_h, wide
    torch.cuda.synchronize()

    # -- 3. serve: the port's paths through their entry points -----------------
    est = CostEstimator(models, device=DEVICE)
    cpu = CostEstimator(models, device="cpu")
    counters = {"banked_mlp": bank_ops.banked_mlp_slotted, "mp_update": mp_ops.mp_update,
                "mp_sweep": sweep_ops.mp_sweep, "gather_sum": seg_ops.gather_sum,
                "segment_sum": seg_ops.segment_sum, "linear_scan": scan_ops.linear_scan}
    path_launches = {}  # path -> launches per kernel, counted from 0 over that path alone

    def counted(path, fn, need, never=()):
        """Run ``fn`` with every launch counter at 0; fail unless each kernel
        of ``need`` launched and none of ``never`` did."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in counters.items()}
        for n, k in counters.items():
            path_launches.setdefault(path, dict.fromkeys(counters, 0))[n] += k.launches
        if any(got[n] == 0 for n in need) or any(got[n] for n in never):
            raise AssertionError(f"{path}: launches {got}; need {need}, never {never}")
        return out, got

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def check_answers(what, got, want, raw):
        """Regression within SERVE_RTOL; votes equal where every member's
        logit in ``raw`` (metric -> (E, B)) is clear of 0 by 1e-3."""
        for m in want:
            a, b = np.asarray(got[m]), np.asarray(want[m])
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{what} {m}: shape {a.shape} against {b.shape}, or non-finite values")
            if m in REGRESSION_METRICS:
                if not np.allclose(a, b, rtol=SERVE_RTOL, atol=1e-6):
                    raise AssertionError(f"{what} {m}: answers disagree (max rel err "
                                         f"{float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))})")
            else:
                clear = (np.abs(raw[m]) > 1e-3).all(axis=0)
                if not np.array_equal(a[clear], b[clear]):
                    raise AssertionError(f"{what} {m}: votes differ away from the threshold")

    def batch_logits(graphs, device):
        """Raw classification logits (metric -> (E, B)) of a host graph batch."""
        gd = graphs_to_device(graphs, device)
        with torch.no_grad():
            return {m: forward_ensemble(nn.to_device(models[m][0], device), gd, models[m][1]).cpu().numpy()
                    for m in CLASSIFICATION_METRICS}

    def placed_logits(q, c, a, device):
        skel_d = graphs_to_device(build_graph_skeleton(q, c), device)
        ap = torch.as_tensor(build_a_place_batch(q, c, a), device=device)
        with torch.no_grad():
            return {m: gnn.apply_gnn_placed_members(nn.to_device(models[m][0], device), skel_d, ap,
                                                    query_static(q), models[m][1].gnn)[..., 0].cpu().numpy()
                    for m in CLASSIFICATION_METRICS}

    def device_split(fn):
        """One warm call under ``torch.profiler``: host wall ms, the device's
        busy ms (kernels and copies), its idle share, how many device
        entries (kernels and copies) it ran, the five costliest, and the
        port's own kernels (launches, ms).  Busy time None: the profiler
        saw no device work."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        dev_rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev_rows) / 1e3
        top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:5]
        ours = {e.key.split("(")[0].replace("repro_torch::", ""): [e.count, e.self_device_time_total / 1e3]
                for e in dev_rows if "repro_torch::" in e.key}
        return {"wall_ms": wall, "device_busy_ms": busy if dev_rows else None,
                "idle_share": 1.0 - busy / wall if dev_rows else None,
                "device_entries": sum(e.count for e in dev_rows),
                "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top], "port_kernels": ours}

    def aten_ops(fn):
        """How many aten operators one call dispatches (views included): the
        host's share of a step that the device waits on."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Count.n += 1
                return func(*args, **(kwargs or {}))

        with Count():
            fn()
        torch.cuda.synchronize()
        return Count.n

    def same_runs(what, one, two):
        for x, y in zip(one if isinstance(one, list) else [one], two if isinstance(two, list) else [two]):
            for m in x:
                if not np.array_equal(x[m], y[m]):
                    raise AssertionError(f"{what} {m}: two runs on the card differ")

    torch.cuda.reset_peak_memory_stats()
    serve = {"phase": "serve", "model": {"hidden": H, "metrics": len(ALL_METRICS), "members": E_MEMBERS,
                                         "use_pallas": True}}
    per_request = ("banked_mlp", "mp_update")

    # estimate: 4096 traces, full-depth scan plan
    (est_out, ms_first), delta = counted("estimate", lambda: timed(lambda: est.estimate(host_batch)), per_request)
    (est_out2, ms_warm), _ = counted("estimate", lambda: timed(lambda: est.estimate(host_batch)), per_request)
    sub = np.arange(min(256, B))
    sub_batch = JointGraph(*[np.asarray(x)[sub] for x in host_batch])
    check_answers("estimate", {m: v[sub] for m, v in est_out.items()}, cpu.estimate(sub_batch),
                  batch_logits(sub_batch, "cpu"))
    same_runs("estimate", est_out, est_out2)
    for m in est_out:
        if est_out[m].shape != (B,) or not np.isfinite(est_out[m]).all():
            raise AssertionError(f"estimate {m}: bad shape or non-finite values")
    serve["estimate"] = {"graphs": int(B), "ms_first": ms_first, "ms": ms_warm, "corpus_s": t_corpus,
                         "featurize_s": t_featurize, "launches": delta}

    # score: 1024 sampled candidates on each of 8 distinct queries
    kinds = ("linear", "two_way", "three_way", "linear", "two_way", "three_way", "two_way", "linear")
    queries = [(workload.query(kind=k, name=f"q{i}"), workload.cluster(4 + i % 4)) for i, k in enumerate(kinds)]
    score_ms, n_cands, score_launches = [], [], []
    for i, (q, c) in enumerate(queries):
        a = sample_assignment_matrix(q, c, SIZES["score_candidates"], np.random.default_rng(i))
        (out, ms), delta = counted("score", lambda: timed(lambda: est.score(q, c, a)), per_request)
        score_launches.append([delta[n] for n in per_request])
        score_ms.append(ms)
        n_cands.append(len(a))
        check_answers(f"score q{i}", out, cpu.score(q, c, a), placed_logits(q, c, a, "cpu"))
    serve["score"] = {"queries": len(queries), "candidates": n_cands, "ms": score_ms,
                      "launches_banked_mlp_mp_update": score_launches}

    # optimize: the paper's placement search on 8 queries
    opt_ms, same = [], 0
    for i, (q, c) in enumerate(queries):
        (r, ms), _ = counted("optimize", lambda: timed(
            lambda: est.optimize(q, c, "latency_p", rng=np.random.default_rng(100 + i))), per_request)
        opt_ms.append(ms)
        r_cpu = cpu.optimize(q, c, "latency_p", rng=np.random.default_rng(100 + i))
        if r.placement.assignment == r_cpu.placement.assignment:
            same += 1
        else:  # a near-tie: the card's pick must score as well on the CPU
            j = [p.assignment for p in r_cpu.candidates].index(r.placement.assignment)
            if not np.isclose(r_cpu.scores[j], r_cpu.predicted["latency_p"], rtol=SERVE_RTOL):
                raise AssertionError(f"optimize q{i}: the card picked a worse placement than the CPU")
    serve["optimize"] = {"queries": len(queries), "ms": opt_ms, "same_placement_as_cpu": same}

    # estimate_many: the 4096 graphs as 8 batches, one merged chunk, the fused
    # sweep (exactly one mp_sweep launch per chunk, no mp_update)
    (many, many_first), d1 = counted("estimate_many", lambda: timed(lambda: est.estimate_many(many_batches)),
                                     ("banked_mlp", "mp_sweep"), ("mp_update", "gather_sum", "segment_sum"))
    (many2, many_warm), d2 = counted("estimate_many", lambda: timed(lambda: est.estimate_many(many_batches)),
                                     ("banked_mlp", "mp_sweep"), ("mp_update", "gather_sum", "segment_sum"))
    if d1["mp_sweep"] != 1 or d2["mp_sweep"] != 1:
        raise AssertionError(f"estimate_many: {d1['mp_sweep']} and {d2['mp_sweep']} mp_sweep launches, want 1 per chunk")
    same_runs("estimate_many", many, many2)
    card_raw = batch_logits(host_batch, dev)
    for i, (b_i, got_i) in enumerate(zip(many_batches, many)):
        rows_i = slice(mb * i, mb * (i + 1))
        check_answers(f"estimate_many batch {i} against estimate on the card", got_i, est.estimate(b_i),
                      {m: v[:, rows_i] for m, v in card_raw.items()})
    subset = [JointGraph(*[x[:16] for x in b_i]) for b_i in many_batches]
    cpu_many = cpu.estimate_many(subset)
    for i, (got_i, want_i) in enumerate(zip(many, cpu_many)):
        check_answers(f"estimate_many batch {i} against the CPU", {m: v[:16] for m, v in got_i.items()}, want_i,
                      batch_logits(subset[i], "cpu"))
    serve["estimate_many"] = {"batches": len(many_batches), "graphs": int(B), "ms_first": many_first,
                              "ms": many_warm, "launches": d2,
                              "profile": device_split(lambda: est.estimate_many(many_batches))}
    serve["estimate"]["profile"] = device_split(lambda: est.estimate(host_batch))

    # score_many: 16 distinct structures x up to 256 candidates, one merged forward
    (sm, sm_first), d1 = counted("score_many", lambda: timed(lambda: est.score_many(drain)),
                                 ("banked_mlp", "gather_sum", "segment_sum"), ("mp_update", "mp_sweep"))
    (sm2, sm_warm), d2 = counted("score_many", lambda: timed(lambda: est.score_many(drain)),
                                 ("banked_mlp", "gather_sum", "segment_sum"), ("mp_update", "mp_sweep"))
    same_runs("score_many", sm, sm2)
    sub_drain = [(q, c, a[:32]) for q, c, a in drain]
    cpu_sm = cpu.score_many(sub_drain)
    for i, ((q, c, a), got_i) in enumerate(zip(drain, sm)):
        check_answers(f"score_many request {i} against score on the card", got_i, est.score(q, c, a),
                      placed_logits(q, c, a, dev))
        check_answers(f"score_many request {i} against the CPU", {m: v[:32] for m, v in got_i.items()},
                      cpu_sm[i], placed_logits(q, c, a[:32], "cpu"))
    serve["score_many"] = {"structures": len(drain), "candidates": int(sum(len(a) for _, _, a in drain)),
                           "ms_first": sm_first, "ms": sm_warm, "launches": d2,
                           "profile": device_split(lambda: est.score_many(drain))}
    torch.cuda.synchronize()
    serve["launches"] = path_launches
    serve["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    emit(serve)
    del est, cpu, stacked, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 4. train: the port's launch/train.py on the 22,000-trace corpus -----------
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "build").mkdir(exist_ok=True)
    train_root = Path(tempfile.mkdtemp(prefix="train_smoke_", dir=ROOT / "build"))
    artifacts.ROOT = str(train_root)  # a temporary artifact store: corpus, five ensembles, the bundle
    launch_train.MAIN_CORPUS = SIZES["train_traces"]
    epochs = SIZES["train_epochs"]
    train = {"phase": "train", "model": {"hidden": H, "metrics": len(ALL_METRICS), "members": E_MEMBERS,
                                         "use_pallas": True, "batch_size": 512, "lr": 1.5e-3, "banding": "exact"},
             "corpus": {"traces": launch_train.MAIN_CORPUS, "seed": launch_train.CORPUS_SEED,
                        "split_seed": launch_train.SPLIT_SEED},
             "cuts": [f"{epochs} epochs a metric instead of 30"]}
    t0 = time.perf_counter()
    corpus = launch_train.main_corpus()
    train["corpus_s"] = time.perf_counter() - t0
    tcfg = CostModelConfig(metric="latency_p", gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=E_MEMBERS)
    pcfg = dataclasses.replace(tcfg, gnn=gnn.GNNConfig(use_pallas=False))
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(corpus, "latency_p"), seed=launch_train.SPLIT_SEED)
    tr_sorted, buckets = batching.bucket_dataset(tr, exact=True)
    steps_per_epoch = batching.n_batches(buckets, 512)
    tcfg_train = loop.TrainConfig(epochs=epochs, batch_size=512, lr=1.5e-3, exact_banding=True)
    opt = loop.make_optimizer(tcfg_train, steps_per_epoch * epochs)
    first = list(itertools.islice(batching.bucketed_batches(tr_sorted, buckets, 512, rng=np.random.default_rng(1),
                                                            device=dev), SIZES["train_trajectory"]))
    g1, y1, band1 = max(first, key=lambda b: len(b[2].levels))  # the deepest of them
    params0 = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), tcfg), dev)
    train.update({"train_graphs": len(tr), "val_graphs": len(va), "buckets": len(buckets),
                  "steps_per_epoch": steps_per_epoch,
                  "step_batch": {"graphs": int(g1.op_x.shape[0]), "levels": len(band1.levels),
                                 "rows": len(band1.rows) if band1.rows is not None else N}})

    # gradient parity on the card: the kernels against the plain path (TF32 off)
    (loss_k, grads_k), step_launches = counted(
        "train_step", lambda: loop.loss_and_grads(params0, g1, y1, tcfg, band1), ("banked_mlp", "mp_sweep"),
        ("mp_update", "gather_sum", "segment_sum", "linear_scan"))
    if (step_launches["banked_mlp"], step_launches["mp_sweep"]) != (4, 1):
        raise AssertionError(f"train step: {step_launches}; want 4 banked_mlp and 1 mp_sweep launches")
    loss_p, grads_p = loop.loss_and_grads(params0, g1, y1, pcfg, band1)
    worst, zero = 0.0, []
    for (path, a), (_, b) in zip(nn.tree_leaves_with_paths(grads_k), nn.tree_leaves_with_paths(grads_p)):
        if float(a.abs().max()) == 0.0:
            zero.append("/".join(path))
        limit = 1e-4 * b.abs() + 1e-5 * float(b.abs().max())
        worst = max(worst, float(((a - b).abs() / limit.clamp(min=1e-30)).max()))
    train["gradient_parity"] = {"loss": float(loss_k), "loss_plain": float(loss_p),
                                "loss_abs_diff": abs(float(loss_k) - float(loss_p)), "tol": TOL,
                                "leaves": len(nn.tree_leaves(grads_k)), "zero_gradient_leaves": zero,
                                "worst_leaf_ratio": worst,
                                "bound": "|kernel - plain| <= 1e-4 |plain| + 1e-5 max|plain leaf|"}
    if zero or worst > 1.0 or not np.isclose(float(loss_k), float(loss_p), rtol=TOL, atol=TOL):
        emit(train)
        raise AssertionError(f"train: kernel and plain gradients disagree (worst {worst}, zero leaves {zero})")

    # each kernel's autograd.Function against autograd of its plain version at
    # the training shape; its backward (the plain VJP) timed
    def grad_case(name):
        r = torch.Generator().manual_seed(7)

        def randn(*shape):
            return torch.randn(shape, generator=r).to(dev).requires_grad_()

        w = [t.detach().clone().requires_grad_() for layer in params0["op_upd"]["layers"] for t in (layer["w"], layer["b"])]

        def lay(w1, b1, w2, b2):
            return {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}

        Bt = int(g1.op_x.shape[0])
        if name == "banked_mlp":
            return (lambda x, *w: bank_ops.banked_mlp_slotted(lay(*w), x, SLOT_RANGES),
                    lambda x, *w: banked_mlp_slotted_ref(lay(*w), x, SLOT_RANGES), [randn(E_MEMBERS, Bt, N, 2 * H), *w])
        if name == "mp_update":
            d1, m1 = g1.op_depth, g1.op_mask
            return (lambda h, a, *w: mp_ops.mp_update(lay(*w), h, a, d1, m1, 2, SLOT_RANGES),
                    lambda h, a, *w: mp_update_ref(lay(*w), h, a, d1, m1, 2, SLOT_RANGES),
                    [randn(E_MEMBERS, Bt, N, H), g1.a_flow.clone().requires_grad_(), *w])
        if name == "mp_sweep":
            keep1 = torch.tensor(band1.rows, device=dev)
            a1 = g1.a_flow.index_select(1, keep1).index_select(2, keep1).contiguous()
            d1 = g1.op_depth.index_select(1, keep1).contiguous()
            m1 = g1.op_mask.index_select(1, keep1).contiguous()
            lv = gnn._banded_plan(band1, band1.ranges).levels
            return (lambda h, a, *w: sweep_ops.mp_sweep(lay(*w), h, a, d1, m1, lv),
                    lambda h, a, *w: mp_sweep_ref(lay(*w), h, a, d1, m1, lv),
                    [randn(E_MEMBERS, Bt, len(band1.rows), H), a1.requires_grad_(), *w])
        if name == "gather_sum":
            flow_in = g1.a_flow.transpose(-1, -2)
            pi = torch.argsort(-flow_in, dim=-1, stable=True)[..., :2]
            return (lambda h, wt: seg_ops.gather_sum(h, pi, wt), lambda h, wt: gather_sum_ref(h, pi, wt),
                    [randn(E_MEMBERS, Bt, N, H), torch.gather(flow_in, -1, pi).requires_grad_()])
        hosts = g1.a_place.argmax(dim=-1)
        return (lambda x: seg_ops.segment_sum(x, hosts, W), lambda x: segment_sum_ref(x, hosts, W),
                [randn(E_MEMBERS, Bt, N, H)])

    backward = {}
    for name in ("banked_mlp", "mp_update", "mp_sweep", "gather_sum", "segment_sum"):
        kernel, plain, ins = grad_case(name)
        out_k = kernel(*ins)
        cot = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(3)).to(dev)
        gk = torch.autograd.grad(out_k, ins, cot, retain_graph=True)
        out_p = plain(*ins)
        gp = torch.autograd.grad(out_p, ins, cot, retain_graph=True)
        bitwise = all(torch.equal(a, b) for a, b in zip(gk, gp))
        close = all(torch.allclose(a, b, rtol=TOL, atol=TOL) for a, b in zip(gk, gp))
        backward[name] = {
            "inputs": [list(t.shape) for t in ins], "bitwise_equal": bitwise, "within_tol": close,
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(gk, gp)),
            "ms": cuda_ms(lambda: torch.autograd.grad(out_k, ins, cot, retain_graph=True)),
            "forward_ms": cuda_ms(lambda: kernel(*ins)),
            "launches_per_step": {"banked_mlp": 4, "mp_sweep": 1}.get(name, 0)}
        # the plain backward of gather_sum adds with atomics; every other one is deterministic
        if not (close if name == "gather_sum" else bitwise):
            emit(train)
            raise AssertionError(f"train: {name}'s autograd.Function disagrees with autograd of its plain version")
        del out_k, out_p, gk, gp, ins
    train["kernel_backward"] = backward

    # one step split into forward, backward and optimizer (host clock, synchronized
    # between the parts), the kernels' path and the plain path
    def step_split(cfg, reps=SIZES["timing_reps"]):
        p, state = params0, opt.init(params0)
        parts = []
        for _ in range(reps + 3):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            live = nn.tree_map(lambda q: q.detach().requires_grad_(), p)
            loss = ensemble_loss(live, g1, y1, cfg, band1)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            flat = torch.autograd.grad(loss, [leaf for _, leaf in nn.tree_leaves_with_paths(live)])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            it = iter(flat)
            updates, state = opt.update(nn.tree_map(lambda _: next(it), p), state, p)
            p = optim.apply_updates(p, updates)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            parts.append(np.diff(t) * 1e3)
        fwd, bwd, upd = np.median(np.asarray(parts[3:]), axis=0)
        return {"forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd, "step_ms": fwd + bwd + upd,
                "backward_share": bwd / (fwd + bwd + upd)}

    def train_steps(cfg, batches):
        p, state, ef = params0, opt.init(params0), ef_init(params0)
        losses = []
        for g, y, band in batches:
            p, state, ef, loss = loop.train_step(p, state, ef, g, y, band, cfg, opt, tcfg_train)
            losses.append(loss)
        return [float(v) for v in losses]

    split_k, split_p = step_split(tcfg), step_split(pcfg)
    reps = [(g1, y1, band1)] * SIZES["timing_reps"]
    _, step_ms = timed(lambda: train_steps(tcfg, reps))
    _, plain_step_ms = timed(lambda: train_steps(pcfg, reps))
    train["step"] = {"kernels": {**split_k, "unsplit_step_ms": step_ms / len(reps)},
                     "plain": {**split_p, "unsplit_step_ms": plain_step_ms / len(reps)},
                     "launches": step_launches,
                     "profile": device_split(lambda: loop.train_step(params0, opt.init(params0), ef_init(params0),
                                                                     g1, y1, band1, tcfg, opt, tcfg_train))}

    # the same first steps of an epoch with the kernels and with the plain path
    traj_k, traj_p = train_steps(tcfg, first), train_steps(pcfg, first)
    rel = [abs(a - b) / abs(b) for a, b in zip(traj_k, traj_p)]
    train["trajectory"] = {"steps": len(first), "loss_kernels": traj_k, "loss_plain": traj_p, "max_rel_diff": max(rel),
                           "bound_rel": TRAJ_REL}
    if max(rel) > TRAJ_REL or not all(np.isfinite(traj_k)):
        emit(train)
        raise AssertionError(f"train: the kernel and plain trajectories part by {max(rel)} (bound {TRAJ_REL})")
    del first, grads_k, grads_p

    # validation loss at the start, per metric: the loop's own init (seed 0)
    init_val = {}
    _, val_index, _ = batching.split_indices(len(corpus), seed=launch_train.SPLIT_SEED)
    val_g, _ = batching.batch_to_device(va.graphs, va.labels, dev)
    val_band = batch_banding(va.graphs)
    with torch.no_grad():
        for m in ALL_METRICS:
            y_val = torch.as_tensor(label_array(corpus, m)[val_index], device=dev)
            cfg_m = dataclasses.replace(tcfg, metric=m)
            init_val[m] = float(ensemble_loss(params0, val_g, y_val, cfg_m, val_band) / E_MEMBERS)

    # the training run itself: launch/train.py's stage_main, counted
    (results, train_ms), got = counted(
        "train", lambda: timed(lambda: launch_train.stage_main(epochs, device=DEVICE)), ("banked_mlp", "mp_sweep"),
        ("mp_update", "gather_sum", "segment_sum", "linear_scan"))
    steps = sum(r.steps for r in results.values())
    n_val = sum(len(r.history) for r in results.values())
    train["run"] = {"seconds": train_ms / 1e3, "steps": steps, "validation_forwards": n_val, "launches": got,
                    "per_metric": {m: {"steps": r.steps, "seconds": [h["seconds"] for h in r.history],
                                       "train_loss": [h["train_loss"] for h in r.history],
                                       "val_loss": [h["val_loss"] for h in r.history], "val_at_init": init_val[m]}
                                   for m, r in results.items()}}
    if (got["banked_mlp"], got["mp_sweep"]) != (4 * (steps + n_val), steps + n_val):
        emit(train)
        raise AssertionError(f"train: {got} over {steps} steps and {n_val} validation forwards; want 4 and 1 each")
    worse = [m for m, r in results.items() if not r.best_val < init_val[m]]
    if worse:
        emit(train)
        raise AssertionError(f"train: validation loss did not fall below its value at init for {worse}")

    # export and serve: the bundle stage_main wrote, on the card, against the
    # trained params' own forward
    bundle = artifacts.load_bundle("main")
    served = CostEstimator.from_bundle(bundle, corpus_fingerprint=corpus_fingerprint(corpus), strict_provenance=True,
                                       device=DEVICE)
    probe = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in corpus[:512]])
    (answers, serve_ms), serve_launches = counted("train_serve", lambda: timed(lambda: served.estimate(probe)),
                                                  ("banked_mlp", "mp_update"))
    probe_d = graphs_to_device(probe, dev)
    own, raw = {}, {}
    with torch.no_grad():
        for m, r in results.items():
            cfg_m = bundle.config(m)
            out = forward_ensemble(nn.to_device(r.params, dev), probe_d, cfg_m).cpu().numpy()
            own[m], raw[m] = _ensemble_vote(out, cfg_m), out
    check_answers("train export", answers, own, raw)
    _, serve_warm_ms = timed(lambda: served.estimate(probe))
    train["export"] = {"bundle_metrics": list(bundle.metrics), "estimate_graphs": len(corpus[:512]),
                       "estimate_ms_first": serve_ms, "estimate_ms": serve_warm_ms, "launches": serve_launches,
                       "meta": bundle.meta}
    train["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    emit(train)
    del served, results, params0, g1, y1, val_g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 5. service and 6. control: the trained bundle behind PlacementService
    # and the fleet controller ------------------------------------------------
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    svc_est, svc_cpu = service_phase(bundle, lambda: artifacts.load_bundle("main"), counted, device_split, card)
    control_phase(svc_est, svc_cpu, counted, card)
    shutil.rmtree(train_root, ignore_errors=True)
    del bundle, svc_est, svc_cpu
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 7. lm: RecurrentGemma-2B serving through make_serve_step -----------------
    costream = ("banked_mlp", "mp_update", "mp_sweep", "gather_sum", "segment_sum")
    n_rec = sum(k == "rec" for k in lm_cfg.pattern) * lm_cfg.n_groups + sum(k == "rec" for k in lm_cfg.suffix)
    prompt, n_dec = SIZES["lm_prompt"], SIZES["lm_decode"]
    max_seq = prompt + n_dec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm_params = materialize(torch.Generator(DEVICE).manual_seed(0), model_defs(lm_cfg), device=DEVICE)
    torch.cuda.synchronize()
    lm = {"phase": "lm", "model": {"arch": lm_cfg.name, "layers": lm_cfg.n_layers(), "rglru_layers": n_rec,
                                   "d_model": lm_cfg.d_model, "vocab": lm_cfg.vocab,
                                   "params": count_params(model_defs(lm_cfg)), "window": lm_cfg.window},
          "requests": lm_b, "prompt": prompt, "decode_steps": n_dec, "max_seq": max_seq,
          "init_s": time.perf_counter() - t0}
    prompts = np.random.default_rng(0).integers(0, lm_cfg.vocab, (lm_b, prompt)).astype(np.int32)
    step = make_serve_step(lm_cfg, device=DEVICE)
    step_plain = make_serve_step(dataclasses.replace(lm_cfg, use_rglru_kernel=False), device=DEVICE)
    empty_cache = materialize(None, model_cache_defs(lm_cfg, lm_b, max_seq), device=DEVICE)

    def lm_step(path, fn, plain=False):
        """One forward with the counters at 0: 18 linear_scan launches (one
        per RG-LRU layer), none with the plain scan, no COSTREAM kernel."""
        (out, ms), got = counted(path, lambda: timed(fn), () if plain else ("linear_scan",),
                                 costream + (("linear_scan",) if plain else ()))
        if not plain and got["linear_scan"] != n_rec:
            raise AssertionError(f"{path}: {got['linear_scan']} linear_scan launches, want {n_rec}")
        return out, ms

    def leaves(tree):
        return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]

    def max_diff(pairs):
        return max(float((a.float() - b.float().to(a.device)).abs().max()) for a, b in pairs)

    def scan_bound(want):
        return LM_SCAN_REL * float(want.abs().max())

    (logits, cache_k, nxt), lm["prefill_ms_first"] = lm_step(
        "lm_prefill", lambda: step(lm_params, empty_cache, prompts, 0))
    if tuple(logits.shape) != (lm_b, prompt, lm_cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm prefill: logits {tuple(logits.shape)}, or non-finite values")
    (logits_p, cache_p, nxt_p), _ = lm_step("lm_prefill_plain", lambda: step_plain(lm_params, empty_cache, prompts, 0),
                                            plain=True)
    diffs = [float((logits - logits_p).abs().max())]
    bounds = [scan_bound(logits_p)]
    same_greedy = int(torch.equal(nxt, nxt_p))
    del logits, logits_p
    prefilled = cache_k
    _, lm["prefill_ms"] = lm_step("lm_prefill", lambda: step(lm_params, empty_cache, prompts, 0))
    lm["prefill_profile"] = device_split(lambda: step(lm_params, empty_cache, prompts, 0))
    # greedy decode; the plain-scan run is teacher-forced with the kernel run's tokens
    tokens, dec_ms = [nxt], []
    for i in range(n_dec):
        (lg, cache_k, nxt), ms = lm_step("lm_decode", lambda: step(lm_params, cache_k, tokens[-1], prompt + i))
        (lg_p, cache_p, nxt_p), _ = lm_step("lm_decode_plain",
                                        lambda: step_plain(lm_params, cache_p, tokens[-1], prompt + i), plain=True)
        if tuple(lg.shape) != (lm_b, 1, lm_cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"lm decode step {i}: logits {tuple(lg.shape)}, or non-finite values")
        diffs.append(float((lg - lg_p).abs().max()))
        bounds.append(scan_bound(lg_p))
        same_greedy += int(torch.equal(nxt, nxt_p))
        dec_ms.append(ms)
        tokens.append(nxt)
    lm["decode_ms_first"], lm["decode_ms"] = dec_ms[0], float(np.mean(dec_ms[1:]))
    lm["decode_ms_min_max"] = [min(dec_ms[1:]), max(dec_ms[1:])]
    lm["decode_profile"] = device_split(lambda: step(lm_params, prefilled, tokens[0], prompt))
    lm["decode_aten_ops"] = aten_ops(lambda: step(lm_params, prefilled, tokens[0], prompt))
    lm["last_position"] = prompt + n_dec - 1
    lm["tokens_per_s"] = {"prefill": lm_b * prompt / (lm["prefill_ms"] / 1e3),
                          "decode": lm_b / (lm["decode_ms"] / 1e3)}
    worst = max(range(len(diffs)), key=lambda j: diffs[j] / max(bounds[j], 1e-30))
    lm["kernel_vs_plain_scan"] = {"max_abs_logit_diff": max(diffs), "worst_step": worst,
                                  "bound_at_worst": bounds[worst], "bound_rule": "2**-8 x max |logit| of the step",
                                  "cache_max_abs_diff": max_diff(zip(leaves(cache_k), leaves(cache_p))),
                                  "same_greedy_tokens": f"{same_greedy} of {n_dec + 1} forwards"}
    if diffs[worst] > bounds[worst]:
        raise AssertionError(f"lm: the kernel run and the plain-scan run differ by {diffs[worst]} at step {worst} "
                             f"(bound {bounds[worst]})")
    lm["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    del lm_params, cache_k, cache_p, prefilled, empty_cache, lg, lg_p
    torch.cuda.empty_cache()

    # the reduced model in fp32 on the card against the CPU, same weights:
    # uncached forward, then prefill into the cache and decode past the window
    r_cfg = reduced(get_config("recurrentgemma-2b"))
    r_cpu = materialize(torch.Generator().manual_seed(1), model_defs(r_cfg), torch.float32, "cpu")
    r_dev = nn.to_device(r_cpu, dev)
    r_toks = np.random.default_rng(1).integers(0, r_cfg.vocab, (2, 12)).astype(np.int32)
    with torch.no_grad():
        want, _ = lm_forward(r_cpu, r_cfg, torch.as_tensor(r_toks))
        got, _ = lm_forward(r_dev, r_cfg, torch.as_tensor(r_toks, device=dev))
    pairs = [(got.cpu(), want)]  # (card, CPU): logits of each forward and every cache leaf after it
    caches = [materialize(None, model_cache_defs(r_cfg, 2, 24), torch.float32, d) for d in ("cpu", DEVICE)]
    step_cpu, step_dev = make_serve_step(r_cfg, device="cpu"), make_serve_step(r_cfg, device=DEVICE)
    pos = 0
    for _ in range(7):  # 12-token prefill, 6 decode steps to position 17
        want, caches[0], r_next = step_cpu(r_cpu, caches[0], r_toks, pos)
        got, caches[1], _ = step_dev(r_dev, caches[1], r_toks, pos)
        pairs += [(a.cpu(), b) for a, b in zip([got] + leaves(caches[1]), [want] + leaves(caches[0]))]
        pos += r_toks.shape[1]
        r_toks = r_next.numpy()
    r_ok = all(torch.allclose(a, b, rtol=LM_RTOL, atol=LM_RTOL) for a, b in pairs)
    lm["reduced_card_vs_cpu"] = {"layers": r_cfg.n_layers(), "window": r_cfg.window, "last_position": pos - 1,
                                 "max_abs_err": max_diff(pairs), "rtol_atol": LM_RTOL, "ok": r_ok}
    emit(lm)
    if not r_ok:
        raise AssertionError(f"lm: the reduced model on the card disagrees with the CPU "
                             f"(max abs err {max_diff(pairs)})")

    # -- 8. kernel summary (the representative case: the most work on the path) -------
    sources = {
        "banked_mlp": ("src/repro_torch/csrc/banked_mlp.cu", "src/repro/kernels/banked_mlp/kernel.py:53"),
        "mp_update": ("src/repro_torch/csrc/mp_update.cu", "src/repro/kernels/mp_update/kernel.py:64"),
        "mp_sweep": ("src/repro_torch/csrc/mp_sweep.cu", "src/repro/kernels/mp_sweep/kernel.py:73"),
        "gather_sum": ("src/repro_torch/csrc/seg_gather.cu", "src/repro/kernels/seg_gather/kernel.py:63"),
        "segment_sum": ("src/repro_torch/csrc/seg_gather.cu", "src/repro/kernels/seg_gather/kernel.py:94"),
        "linear_scan": ("src/repro_torch/csrc/rglru.cu", "src/repro/kernels/rglru/kernel.py:55"),
    }
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = max(mine, key=lambda r: r["flops"])
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(path[name] for path in path_launches.values()),
                        "launches_by_path": {k: v[name] for k, v in path_launches.items() if v[name]},
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"], "case": rep["case"],
                        "shape": rep["shape"], **{k: rep[k] for k in ("per_level_ms", "per_level_max_abs_err") if k in rep},
                        # the backward: the plain version's VJP, at the training shape
                        "backward_ms": backward[name]["ms"] if name in backward else None,
                        "backward_launches_per_train_step": backward[name]["launches_per_step"] if name in backward else 0})
    emit({"kernels": summary})

    # -- 9. the card, 10. status ---------------------------------------------------
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
