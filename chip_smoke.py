#!/usr/bin/env python3
"""Drive the PyTorch port's serving, service, training and LM paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py

Each phase prints one JSON line:
  build    nvcc build of every kernel (time; registers, spills and shared memory
           per kernel; the TF32 tensor-core MMAs in banked_mlp's, mp_update's and
           mp_sweep's SASS, which must be there, with no spills)
  kernels  each CUDA kernel against its plain PyTorch version at the shapes its
           path gives it (max abs error beside the tolerance; kernel, plain,
           bound and, where one PyTorch call computes the same function,
           library ms; for mp_sweep also per_level_ms, its levels as one
           mp_update launch each, held against the plain version too); and
           the JAX kernels' width envelope at the same shapes: banked_mlp,
           mp_update and mp_sweep at hidden 100 (zero-padded to 104) and
           mp_sweep at hidden 128 (its 16-row fp32 z tile)
  serve    a full-width COSTREAM model (5 metrics x 3 members, hidden 64,
           use_pallas=True) answering estimate / score / optimize requests and
           the cross-query estimate_many / score_many, each answer held against
           the card's per-request answers and the same estimator on the CPU;
           every path reads the launch counters (repro_torch.obs) just before it
           and just after, and fails if one of its kernels did not launch
  train    launch/train.py's main stage at full width (22,000 traces, 5 metrics x 3
           members, hidden 64, batch 512, exact banding, use_pallas=True), cut to 2
           epochs a metric: gradients through the kernels against the plain path
           on one batch (every leaf nonzero), each kernel's autograd.Function
           against autograd of its plain version (its backward timed), a step
           split into forward / backward / optimizer beside the plain path's, a
           profiled step, 20 steps with the kernels and with the plain path,
           validation loss below its value at init for every metric, and the
           exported bundle served on the card against the trained params
  distributed the distribution substrate on one NCCL rank of the card (file://
           rendezvous): make_dp_train_step on the train phase's batch against
           training/loop.py's train_step (parameters bitwise equal), 20
           int8-compressed steps whose loss must fall, the all-reduce of every
           gradient leaf timed, pipeline_forward at one stage against its stage,
           the train phase's stored model re-sharded onto the card
  baselines the paper's baselines and ablations in the train phase's artifact root
           (hidden 64, 3 members): the traditional-MP forward over the serve phase's
           4096 graphs (8 banked_mlp launches and no other kernel; kernel against
           plain and the CPU; its op_upd launch in the kernel table), its gradient
           against the plain path and a step split; launch/train.py's ablations,
           flat, extrap and finetune stages, cut in epochs and corpus sizes (each
           run's validation loss below its value at init, but extrap's, which
           extrap_parity holds against the CPU; each stage's launches counted;
           flat predictions on the card against the CPU); the
           ablate_traditional_* models served on the card (score of 1024
           candidates, optimize, per-request score_many) against the CPU
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
  lm_train the lm phase's weights trained through make_train_step (2 x 2048 seeded
           tokens, remat "full", Adam with float32 moments): a warm step whose
           linear_scan launches are counted (18 forward, 16 recomputed in the
           remat'd groups, 18 reversed scans in the backward), 5 steps split into
           forward, backward and optimizer whose loss must fall and grad norm stay
           finite, peak memory; the step's loss and grad norm with the plain scan
           against the kernel; the scan's backward at (2, 2048, 2560) against the
           plain VJP within 1e-5 x max|plain|, both timed
  lm_archs one line an architecture for internlm2-1.8b, qwen3-8b, gemma2-2b,
           deepseek-67b, arctic-480b, deepseek-v2-236b, xlstm-125m, internvl2-1b and
           whisper-base (LM_ARCHS): one period of the layer pattern at the published
           widths in fp32 (the MoE at capacity factor E / k, so that no pair drops;
           whisper one encoder and one decoder group over 1500 frames), its cached
           path's decode steps against the uncached forward; the reduced config in
           fp32 on the card against the CPU; random bf16 weights at the published
           widths (depth cut where the card cannot hold them: LM_ARCHS) serving 2
           requests, prompts prefilled into the cache (2048 tokens; gemma2's
           4096-token window; internvl2 1024 seeded patch embeddings and 1024 tokens
           through forward with the cache; whisper 1500 seeded frames through
           run_encoder and cross_kv into the cache's cross-attention rows, then a
           64-token prompt in a 448-position cache) and 32 greedy decode steps:
           prefill and decode times, the device split, the aten operators of a decode
           step, peak memory; none of the six kernels launches on any of these paths
  lm_archs_train one line an architecture for the nine above (LM_ARCHS_TRAIN;
           RecurrentGemma trains in lm_train): the reduced config in fp32, 3
           make_train_step steps on the card against the CPU (loss and grad norm);
           random bf16 weights at the published widths (depth cut where 22.6 B a
           parameter pass the card; arctic-480b, whose one layer needs 163 GB, runs
           the reduced check only), remat "full", Adam with fp32 moments, 2 x 2048
           tokens (internvl2 1024 patch embeddings + 1024 tokens, whisper 1500 frames
           + 448 tokens, xlstm 2 x 512): a warm step, 3 steps split into forward,
           backward and optimizer, every loss and grad norm finite, tokens/s, peak
           memory; none of the six kernels launches
  examples the port's five examples (repro_torch.examples) through their
           main(argv) on the card: quickstart, optimize_placement and
           controller_demo at their defaults, serve_lm at its default (the
           reduced recurrentgemma-2b; linear_scan launches), train_lm on the
           full xlstm-125m with a failure injected (exit 17), the restart from
           its checkpoint and an uninterrupted run, whose losses the restart
           must match within TRAJ_REL; time and peak memory of each
  dryrun   the port's dry run (launch/dryrun.py), in child processes started
           side by side once every timed phase is over (they run on the host
           CPU, every tensor on the meta device, so no timing shares the host
           with them; the distributed phase holds an NCCL default group, the
           dry run a fake one): the three
           hillclimb cells and their five variants (launch/hillclimb.py) on the
           16 x 16 mesh, one line each with the compute, memory and collective
           terms on H100 data-sheet constants, the bottleneck and the per-GPU
           memory, each of which must end ok; then each step that lm, lm_archs
           and lm_archs_train timed, counted on one GPU at its cut and shape,
           one line each beside its measured ms (a compute term above 1.05 x
           the measured time fails) and its predicted peak beside
           max_memory_allocated; the RecurrentGemma prefill's count must charge
           its 18 linear_scan launches by the kernel's formula
  extrap_parity the baselines phase's 40 extrap runs trained again on the CPU
           plain path (same corpora, init and batch order) in child processes
           beside the dry run's, each also under kernel-sized perturbations;
           each run's validation loss on the card within TRAJ_REL of the CPU's
           plus twice the perturbed runs' spread (EXTRAP_PERTURB)
then the kernel summary line, the card's name and power limit, and the status
line.  Any failure exits nonzero; so does a machine without a CUDA device, or
a directory that holds this script and nothing else of the repository.
"""

import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
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
# The lm_train phase holds one step's loss and grad norm with the kernel against
# the plain scan by the same bound.  On the CPU in float32 the port's step
# agrees with the JAX package's within 1e-6 relative (loss and grad norm,
# tests/test_torch_lm_train.py), so the float32 algorithm adds nothing
# measurable; what the card adds is the bf16 model: the scans agree within
# TOL, and each layer rounds h to bf16 before its output projection, so a value
# may land one bf16 ulp (2**-8 relative) the other way.  The loss and the grad
# norm are means and norms over millions of such terms, so they differ by far
# less than one ulp of their own; 2**-8 is the loosest bound that still fails on
# a wrong gradient or a wrong launch.
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
         "svc_profile_drains": 20, "ctl_queries": 8, "ctl_ticks": 30,
         "trad_cpu_graphs": 512, "ablation_epochs": 1, "flat_epochs": 4, "extrap_traces": 400, "extrap_epochs": 1,
         "finetune_traces": 600, "finetune_epochs": 2, "lm_train_batch": 2, "lm_train_steps": 5,
         "dp_int8_steps": 20, "archs_batch": 2, "archs_prompt": 2048, "archs_decode": 32,
         "archs_check_prompt": 256, "archs_check_decode": 8, "whisper_prompt": 64, "whisper_context": 448,
         "archs_train_batch": 2, "archs_train_seq": 2048, "archs_train_steps": 3}
DEVICE = "cuda"
#: The lm_archs phase's architectures, at their published widths.  Depth is
#: cut (layer groups run) only where one 80 GB card cannot hold the bf16
#: weights beside the activations; None runs every layer.
LM_ARCHS = {
    "internlm2-1.8b": None,  # 24 layers, 3.8 GB
    "qwen3-8b": None,  # 36 layers, 16.4 GB
    "gemma2-2b": None,  # 26 layers, 5.2 GB; its prompt is its 4096-token window, so decode crosses it
    "deepseek-67b": 32,  # 32 of 95 layers: 44 GB, + 3.4 GB of embedding and head
    "arctic-480b": 2,  # 2 of 35 layers, all 128 experts (13.6e9 parameters a layer): 54 GB + 0.9 GB
    "deepseek-v2-236b": 5,  # the dense MLA layer + 5 of 59 MLA-MoE layers, all 160 experts: 40 GB + 2.1 GB
    "xlstm-125m": None,  # 12 layers, 0.3 GB
    "internvl2-1b": None,  # 24 layers, 1.3 GB
    "whisper-base": None,  # 6 encoder + 6 decoder layers, 0.14 GB
}
#: The lm_archs_train phase's architectures: (layer groups trained, None for
#: all, or why none train at full width; tokens a sequence, None for
#: archs_train_seq).  A train step holds bf16 weights and gradients and two
#: float32 Adam moments, 12 B a parameter, and while ``apply_update`` runs the
#: new weights and moments sit beside the old: RecurrentGemma-2B's 2.895e9
#: parameters peaked at 65.45e9 B in lm_train (NVIDIA H100 80GB HBM3, 700 W),
#: 22.6 B a parameter.
#: Depth is cut where 22.6 B x the parameters pass about 70e9 B of the card's
#: 85e9 (the activations of 2 x 2048 positions under remat "full" come on top,
#: and the Adam temporaries of the last large leaf: qwen3-8b and deepseek-67b
#: as cut peaked at 75.7e9 and 75.4e9 B on the H100, so one more layer of
#: either would not fit).
LM_ARCHS_TRAIN = {
    "internlm2-1.8b": (None, None),  # 1.889e9 x 22.6 B = 42.7 GB
    "qwen3-8b": (9, None),  # all 36: 8.191e9 (98 GB at 12 B); 1.245e9 + 9 x 0.193e9 = 2.982e9 -> 67.4 GB
    "deepseek-67b": (2, None),  # all 95: 67.4e9; 1.678e9 + 2 x 0.692e9 = 3.062e9 -> 69.2 GB
    "gemma2-2b": (None, None),  # 2.614e9 -> 59.1 GB
    # one layer is 13.611e9 parameters, 163 GB at 12 B: not even the state between steps fits
    "arctic-480b": ("none: one layer's 13.611e9 parameters take 163 GB at 12 B (bf16 weight and gradient, "
                    "two fp32 moments), above the card's 80 GB", None),
    # 1.387e9 outside the MoE layers (embedding, head, the dense MLA layer) -> 31.3 GB; one MLA-MoE
    # layer adds 3.972e9: 5.359e9 x 22.6 B = 121 GB (64.3 GB at 12 B before the update), so none
    "deepseek-v2-236b": (0, None),
    # 0.124e9 -> 2.8 GB.  Its lm_archs prefill of 2 x 2048 took 7.5 s on the H100, a time loop on
    # the host; a step under remat "full" runs that loop forward twice and backward once: about 30 s
    "xlstm-125m": (None, 512),
    "internvl2-1b": (None, None),  # 0.630e9 -> 14.2 GB; 1024 patch embeddings + 1024 tokens
    "whisper-base": (None, 448),  # 0.071e9 -> 1.6 GB; 1500 frames + 448 tokens, its text context
}


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
            host = build_graph_skeleton(q, c)
            skel, n_hw = graphs_to_device(host, e.device), int(host.hw_mask.sum())
            ap = torch.as_tensor(build_a_place_batch(q, c, a), device=e.device)
            return {m: gnn.apply_gnn_placed_stacked(e._params_for(m), skel, ap, query_static(q), e.config(m).gnn, n_hw)
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


def baselines_phase(corpus, host_batch, query, counted, device_split, timed, check_answers, bank_case, step_split,
                    card):
    """The paper's baselines and ablations on the card, in the ``train``
    phase's artifact root: the traditional-MP forward (kernel against plain
    and the CPU) and its gradient, launch/train.py's ablations, flat, extrap
    and finetune stages (validation loss below its value at init for every
    run), and an ablation bundle served.  Returns the ``banked_mlp`` row of
    the traditional ``op_upd`` shape for the kernel summary."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import nn
    from repro_torch.core import gnn
    from repro_torch.core.flat_vector import FlatVectorConfig, featurize_flat_traces, forward_flat, init_flat_model
    from repro_torch.core.graph import SLOT_RANGES, JointGraph, batch_banding, batch_graphs, build_graph
    from repro_torch.core.graph import drop_hardware, drop_hw_features
    from repro_torch.core.model import (ALL_METRICS, REGRESSION_METRICS, CostModelConfig, bce_loss, ensemble_loss,
                                        forward_ensemble, init_cost_model, label_array, msle_loss)
    from repro_torch.launch import artifacts
    from repro_torch.launch import train as launch_train
    from repro_torch.placement.enumerate import sample_assignment_matrix
    from repro_torch.serve.estimator import CostEstimator, graphs_to_device
    from repro_torch.serve.stacking import _ensemble_vote
    from repro_torch.training import batching, loop

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device(DEVICE)
    E = 3
    tcfg = CostModelConfig(metric="latency_p", gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=E, traditional_mp=True)
    pcfg = dc.replace(tcfg, gnn=gnn.GNNConfig(use_pallas=False))
    costream = ("mp_update", "mp_sweep", "gather_sum", "segment_sum", "linear_scan")
    out = {"phase": "baselines", "card": card,
           "model": {"hidden": tcfg.gnn.hidden, "members": E, "n_rounds": 3, "use_pallas": True},
           "cuts": [f"ablations: {SIZES['ablation_epochs']} epoch(s) a run instead of 16",
                    f"flat: {SIZES['flat_epochs']} epochs a metric instead of 26",
                    f"extrap: {SIZES['extrap_traces']} traces a corpus instead of 6,000, "
                    f"{SIZES['extrap_epochs']} epoch(s) instead of 12",
                    f"finetune: {SIZES['finetune_traces']} traces instead of 3,000, "
                    f"{SIZES['finetune_epochs']} epochs instead of 8"]}

    # -- the traditional forward over the serve phase's graphs, kernel against plain
    params = nn.to_device(init_cost_model(torch.Generator().manual_seed(0), tcfg), dev)
    g = graphs_to_device(host_batch, dev)
    B = int(g.op_x.shape[0])

    def forward(cfg, gg=g, p=params):
        with torch.no_grad():
            return forward_ensemble(p, gg, cfg)

    (raw_k, ms_first), launches = counted("traditional_forward", lambda: timed(lambda: forward(tcfg)),
                                          ("banked_mlp",), costream)
    if launches["banked_mlp"] != 8:
        raise AssertionError(f"traditional forward: {launches}; want 8 banked_mlp launches")
    (raw_k2, ms_warm), _ = counted("traditional_forward", lambda: timed(lambda: forward(tcfg)), ("banked_mlp",), costream)
    raw_p, plain_ms = timed(lambda: forward(pcfg))
    sub = np.arange(min(SIZES["trad_cpu_graphs"], B))
    sub_batch = JointGraph(*[np.asarray(x)[sub] for x in host_batch])
    raw_cpu = forward(pcfg, graphs_to_device(sub_batch, "cpu"), nn.to_device(params, "cpu"))
    votes = {k: _ensemble_vote(r.cpu().numpy(), tcfg) for k, r in (("kernel", raw_k), ("plain", raw_p))}
    check_answers("traditional forward, kernel against plain", {"latency_p": votes["kernel"]},
                  {"latency_p": votes["plain"]}, {})
    check_answers("traditional forward, card against the CPU", {"latency_p": votes["kernel"][sub]},
                  {"latency_p": _ensemble_vote(raw_cpu.numpy(), tcfg)}, {})
    if not torch.equal(raw_k, raw_k2) or tuple(raw_k.shape) != (E, B):
        raise AssertionError(f"traditional forward: shape {tuple(raw_k.shape)} or two runs on the card differ")
    out["forward"] = {"graphs": B, "ms_first": ms_first, "ms": ms_warm, "plain_ms": plain_ms, "launches": launches,
                      "max_abs_raw_diff_plain": float((raw_k - raw_p).abs().max()),
                      "max_abs_raw_diff_cpu": float((raw_k[:, sub].cpu() - raw_cpu).abs().max()),
                      "bound": f"rtol {SERVE_RTOL}, atol 1e-6 on the answers", "cpu_graphs": len(sub),
                      "profile": device_split(lambda: forward(tcfg))}
    # the banked_mlp launch at op_upd's traditional shape: every op row of every
    # graph, [h, a_sym h + a_place h_hw] at 2H columns, round 1's real input
    with torch.no_grad():
        op_mask, hw_mask = g.op_mask[..., None], g.hw_mask[..., None]
        h_o = gnn._apply_bank(params["op_enc"], g.op_x.expand(E, *g.op_x.shape), pcfg.gnn) * op_mask
        h_w = gnn._apply_shared(params["hw_enc"], g.hw_x.expand(E, *g.hw_x.shape), pcfg.gnn, "hw_enc") * hw_mask
        x_upd = torch.cat([h_o, (g.a_flow + g.a_flow.transpose(-1, -2)) @ h_o + g.a_place @ h_w], dim=-1)
    row = bank_case(f"op_upd, traditional round, F=128, T=5, {E} members, every op row", params["op_upd"], x_upd,
                    SLOT_RANGES, False)
    del raw_k, raw_k2, raw_p, x_upd, h_o, h_w, g

    # -- traditional training: one batch's gradient, the step split --------------------
    tr, va, _ = batching.split_dataset(batching.dataset_from_traces(corpus, "latency_p"), seed=launch_train.SPLIT_SEED)
    tr, buckets = batching.bucket_dataset(tr, exact=True)
    g1, y1, band1 = next(iter(batching.bucketed_batches(tr, buckets, 512, rng=np.random.default_rng(2), device=dev)))
    (loss_k, grads_k), step_launches = counted("traditional_train_step",
                                               lambda: loop.loss_and_grads(params, g1, y1, tcfg, band1),
                                               ("banked_mlp",), costream)
    loss_p, grads_p = loop.loss_and_grads(params, g1, y1, pcfg, band1)
    worst, zero = 0.0, []
    for (path, a), (_, b) in zip(nn.tree_leaves_with_paths(grads_k), nn.tree_leaves_with_paths(grads_p)):
        if float(a.abs().max()) == 0.0:
            zero.append("/".join(path))
        limit = 1e-4 * b.abs() + 1e-5 * float(b.abs().max())
        worst = max(worst, float(((a - b).abs() / limit.clamp(min=1e-30)).max()))
    out["gradient_parity"] = {"graphs": int(g1.op_x.shape[0]), "loss": float(loss_k), "loss_plain": float(loss_p),
                              "leaves": len(nn.tree_leaves(grads_k)), "zero_gradient_leaves": zero,
                              "worst_leaf_ratio": worst, "launches": step_launches,
                              "bound": "|kernel - plain| <= 1e-4 |plain| + 1e-5 max|plain leaf|"}
    if step_launches["banked_mlp"] != 8 or zero or worst > 1.0 or not np.isclose(float(loss_k), float(loss_p),
                                                                                 rtol=TOL, atol=TOL):
        emit(out)
        raise AssertionError(f"traditional gradient: launches {step_launches}, worst {worst}, zero leaves {zero}")
    out["step"] = {"kernels": step_split(tcfg, params, (g1, y1, band1)),
                   "plain": step_split(pcfg, params, (g1, y1, band1))}
    del grads_k, grads_p, g1, y1

    # validation loss at init, as the loop's own init (seed 0) or a given start
    def val_at_init(graphs, y, cfg, start=None):
        p = start if start is not None else init_cost_model(torch.Generator().manual_seed(0), cfg)
        gd, yd = batching.batch_to_device(graphs, y, dev)
        with torch.no_grad():
            return float(ensemble_loss(nn.to_device(p, dev), gd, yd, cfg, batch_banding(graphs)) / cfg.n_ensemble)

    def runs_record(results, init_vals, stage, below_init=True):
        """Each run's record; fails unless every run trained (nothing was
        stored already) and (``below_init``) ended below its validation loss
        at init."""
        if any(r is None for r in results.values()):
            raise AssertionError(f"{stage}: a run found its artifact stored already: {results}")
        rec = {n: {"steps": r.steps, "val_loss": [h["val_loss"] for h in r.history], "best_val": r.best_val,
                   "val_at_init": init_vals[n], "seconds": sum(h["seconds"] for h in r.history)}
               for n, r in results.items()}
        worse = [n for n, r in results.items() if below_init and not r.best_val < init_vals[n]]
        if worse:
            emit({**out, stage: rec})
            raise AssertionError(f"{stage}: validation loss did not fall below its value at init for {worse}")
        return rec

    def launches_per_forward(results, cfgs):
        """banked_mlp and mp_sweep launches the runs must make: each step and
        each validation forward is one forward."""
        want = {"banked_mlp": 0, "mp_sweep": 0}
        for n, r in results.items():
            fwd = r.steps + len(r.history)
            want["banked_mlp"] += fwd * (8 if cfgs[n].traditional_mp else 4)
            want["mp_sweep"] += 0 if cfgs[n].traditional_mp else fwd
        return want

    # -- stage_ablations: Exp 7a (featurization) and Exp 7b (traditional MP) ------------
    _, val_index, _ = batching.split_indices(len(corpus), seed=launch_train.SPLIT_SEED)
    va_traces = [corpus[i] for i in val_index]
    plain_graphs = va.graphs
    abl_cfgs, abl_init = {}, {}
    for name, metric, transform, trad in (
        ("ablate_full_latency_e", "latency_e", None, False),
        ("ablate_no_hw_nodes_latency_e", "latency_e", drop_hardware, False),
        ("ablate_no_hw_feats_latency_e", "latency_e", drop_hw_features, False),
        *((f"ablate_traditional_{m}", m, None, True) for m in REGRESSION_METRICS),
    ):
        abl_cfgs[name] = CostModelConfig(metric=metric, gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=E,
                                         traditional_mp=trad)
        graphs = plain_graphs if transform is None else transform(plain_graphs)
        abl_init[name] = val_at_init(graphs, label_array(va_traces, metric), abl_cfgs[name])
    (abl, abl_s), abl_launches = counted("ablations", lambda: timed(
        lambda: launch_train.stage_ablations(SIZES["ablation_epochs"], device=DEVICE)), ("banked_mlp", "mp_sweep"),
        ("mp_update", "gather_sum", "segment_sum", "linear_scan"))
    out["ablations"] = {"seconds": abl_s / 1e3, "epochs": SIZES["ablation_epochs"], "launches": abl_launches,
                        "runs": runs_record(abl, abl_init, "ablations")}
    want = launches_per_forward(abl, abl_cfgs)
    if {k: abl_launches[k] for k in want} != want:
        emit(out)
        raise AssertionError(f"ablations: launches {abl_launches}, want {want}")

    # -- stage_flat: the flat-vector baselines ------------------------------------------
    x_va = featurize_flat_traces(va_traces)
    (flat, flat_s), flat_launches = counted("flat", lambda: timed(
        lambda: launch_train.stage_flat(SIZES["flat_epochs"], device=DEVICE)), (),
        ("banked_mlp",) + costream)
    flat_rec, bad = {}, []
    for m, (fp, seconds) in flat.items():
        task = "regression" if m in REGRESSION_METRICS else "classification"
        fcfg = FlatVectorConfig(task=task)
        base = msle_loss if task == "regression" else bce_loss
        y_va = torch.as_tensor(label_array(va_traces, m), device=dev)
        xd = torch.as_tensor(x_va, device=dev)
        with torch.no_grad():
            v0 = float(base(forward_flat(nn.to_device(init_flat_model(torch.Generator().manual_seed(0), fcfg), dev),
                                         xd), y_va))
            v1 = float(base(forward_flat(nn.to_device(fp, dev), xd), y_va))
            logits = forward_flat(nn.to_device(fp, dev), xd).cpu().numpy()
        card_pred = loop.predict_flat(fp, x_va, task, device=DEVICE)
        cpu_pred = loop.predict_flat(fp, x_va, task, device="cpu")
        if task == "regression":
            agree = bool(np.allclose(card_pred, cpu_pred, rtol=1e-5, atol=1e-6))
        else:
            clear = np.abs(logits) > 1e-5
            agree = bool(np.array_equal(card_pred[clear], cpu_pred[clear]))
        flat_rec[m] = {"seconds": seconds, "val_at_init": v0, "val_loss": v1, "predict_card_equals_cpu": agree,
                       "max_abs_diff": float(np.max(np.abs(card_pred.astype(np.float64) - cpu_pred)))}
        if not (agree and v1 < v0):
            bad.append(m)
    out["flat"] = {"seconds": flat_s / 1e3, "epochs": SIZES["flat_epochs"], "val_rows": len(va_traces),
                   "launches": flat_launches, "per_metric": flat_rec}
    if bad:
        emit(out)
        raise AssertionError(f"flat: prediction on the card differs from the CPU, or validation loss did not fall: {bad}")

    # -- stage_extrap: restricted-range retrains, one member a metric ---------------------
    launch_train.EXTRAP_CORPUS = SIZES["extrap_traces"]
    (ext, ext_s), ext_launches = counted("extrap", lambda: timed(
        lambda: launch_train.stage_extrap(SIZES["extrap_epochs"], device=DEVICE)), ("banked_mlp", "mp_sweep"),
        ("mp_update", "gather_sum", "segment_sum", "linear_scan"))
    ext_cfgs, ext_init = {}, {}
    for direction in ("stronger", "weaker"):
        for dim in ("ram", "cpu", "bandwidth", "latency"):
            traces = launch_train.corpus_cache(f"extrap_{direction}_{dim}", None)  # built by the stage
            _, vi, _ = batching.split_indices(len(traces), seed=launch_train.SPLIT_SEED)
            vt = [traces[i] for i in vi]
            graphs = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in vt])
            for m in ALL_METRICS:
                name = f"extrap_{direction}_{dim}_{m}"
                ext_cfgs[name] = CostModelConfig(metric=m, gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=1)
                ext_init[name] = val_at_init(graphs, label_array(vt, m), ext_cfgs[name])
    # each run is held against the same run on the CPU plain path
    # (extrap_parity, from child processes started with the dry run's), not
    # against its value at init: one epoch on 400 traces does not lower every
    # run's loss, on the CPU either (PERF.md)
    out["extrap"] = {"seconds": ext_s / 1e3, "corpus_traces": SIZES["extrap_traces"], "epochs": SIZES["extrap_epochs"],
                     "launches": ext_launches, "runs": runs_record(ext, ext_init, "extrap", below_init=False)}
    want = launches_per_forward(ext, ext_cfgs)
    if {k: ext_launches[k] for k in want} != want:
        emit(out)
        raise AssertionError(f"extrap: launches {ext_launches}, want {want}")
    extrap_dir = Path(tempfile.mkdtemp(prefix="extrap_cpu_", dir=ROOT / "build"))
    for direction in ("stronger", "weaker"):
        for dim in ("ram", "cpu", "bandwidth", "latency"):
            shutil.copy(artifacts.path("corpus", f"extrap_{direction}_{dim}.torch.pkl"), extrap_dir)
    with open(extrap_dir / "request.json", "w") as f:
        json.dump({"epochs": SIZES["extrap_epochs"]}, f)

    # -- stage_finetune: main_throughput on the filter-chain corpus ---------------------------
    launch_train.FINETUNE_N = SIZES["finetune_traces"]
    base_params, base_cfg = artifacts.load_cost_model("main_throughput")
    (ft, ft_s), ft_launches = counted("finetune", lambda: timed(
        lambda: launch_train.stage_finetune(SIZES["finetune_epochs"], device=DEVICE)), ("banked_mlp", "mp_sweep"),
        ("mp_update", "gather_sum", "segment_sum", "linear_scan"))
    chains = launch_train.finetune_corpus()
    _, vi, _ = batching.split_indices(len(chains), (0.9, 0.1, 0.0), seed=launch_train.SPLIT_SEED)
    vt = [chains[i] for i in vi]
    ft_init = val_at_init(batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in vt]),
                          label_array(vt, "throughput"), base_cfg, start=base_params)
    with open(Path(artifacts.path("costream", "finetune_throughput", "step_0000000000", "manifest.json"))) as f:
        ft_extra = json.load(f)["extra"]
    out["finetune"] = {"seconds": ft_s / 1e3, "traces": len(chains), "epochs": SIZES["finetune_epochs"],
                       "launches": ft_launches, "finetuned_from": ft_extra.get("finetuned_from"),
                       "runs": runs_record({"finetune_throughput": ft}, {"finetune_throughput": ft_init}, "finetune")}
    if ft_extra.get("finetuned_from") != "main_throughput":
        raise AssertionError(f"finetune: stored extra {ft_extra}")

    # -- the ablation bundle served on the card against the CPU ---------------------------
    models = {m: artifacts.load_cost_model(f"ablate_traditional_{m}") for m in REGRESSION_METRICS}
    est, cpu = CostEstimator(models, device=DEVICE), CostEstimator(models, device="cpu")
    q, c = query
    a = sample_assignment_matrix(q, c, SIZES["score_candidates"], np.random.default_rng(7))
    (got, score_ms), score_launches = counted("ablation_score", lambda: timed(lambda: est.score(q, c, a)),
                                              ("banked_mlp",), costream)
    check_answers("ablation bundle score", got, cpu.score(q, c, a), {})
    (r, opt_ms), _ = counted("ablation_optimize", lambda: timed(
        lambda: est.optimize(q, c, "latency_p", k=64, rng=np.random.default_rng(3))), ("banked_mlp",), costream)
    r_cpu = cpu.optimize(q, c, "latency_p", k=64, rng=np.random.default_rng(3))
    if r.placement.assignment != r_cpu.placement.assignment:
        j = [p.assignment for p in r_cpu.candidates].index(r.placement.assignment)
        if not np.isclose(r_cpu.scores[j], r_cpu.predicted["latency_p"], rtol=SERVE_RTOL):
            raise AssertionError("ablation bundle optimize: the card picked a worse placement than the CPU")
    reqs = [(q, c, a[: len(a) // 2]), (q, c, a[len(a) // 2 :])]
    many = est.score_many(reqs)
    for i, (rq, ans) in enumerate(zip(reqs, many)):
        for m, v in est.score(*rq).items():
            if not np.array_equal(ans[m], v):
                raise AssertionError(f"ablation bundle score_many request {i} {m}: differs from its own score")
    if est.supports_cross_query() or est._merged_groups:
        raise AssertionError("ablation bundle: a traditional bundle must answer per request")
    out["serve"] = {"metrics": list(models), "members": sum(p[1].n_ensemble for p in models.values()),
                    "score": {"candidates": len(a), "ms": score_ms, "launches": score_launches},
                    "optimize": {"k": 64, "ms": opt_ms, "same_placement_as_cpu":
                                 r.placement.assignment == r_cpu.placement.assignment},
                    "score_many_per_request": True, "supports_cross_query": False}
    out["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return row, (extrap_dir, out["extrap"]["runs"])


def distributed_phase(params0, batch, cfg, opt, loop_cfg, counted, cuda_ms, timed, card):
    """The distribution substrate on one rank of the card: ``torch.distributed``
    with NCCL (gloo for a CPU dry run), world size 1, rendezvous through a
    ``file://`` store in a temporary directory.  One card gives one rank
    (NCCL takes one rank a GPU), so the several-rank paths are held on gloo
    CPU groups by ``tests/test_torch_distributed.py``.  The data-parallel
    step against ``training/loop.py:train_step`` on the train phase's batch,
    with the same optimizer (parameters bitwise equal: a one-rank all-reduce
    is the identity, the division by 1 exact); 20 int8-compressed steps,
    whose loss must fall; the all-reduce of every gradient leaf, timed; the
    pipeline at one stage against its stage; the train phase's checkpoint
    re-sharded onto the card, equal to what was stored."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import nn
    from repro_torch.core.model import ensemble_loss
    from repro_torch.distributed import make_dp_train_step, pipeline_forward
    from repro_torch.launch import artifacts
    from repro_torch.training import elastic, loop, optim
    from repro_torch.training.compression import ef_init

    t_phase = time.perf_counter()
    costream_step = ("banked_mlp", "mp_sweep")
    not_in_step = ("mp_update", "gather_sum", "segment_sum", "linear_scan")
    g1, y1, band1 = batch
    store = Path(tempfile.mkdtemp(prefix="dist_smoke_", dir=ROOT / "build"))
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store / 'store'}", rank=0, world_size=1)
    out = {"phase": "distributed", "card": card, "backend": backend, "world_size": dist.get_world_size(),
           "batch_graphs": int(g1.op_x.shape[0])}

    def loss_fn(p, b):
        return ensemble_loss(p, b[0], b[1], cfg, band1)

    def fresh(o):
        return {"params": params0, "opt": o.init(params0), "step": 0}

    # the DP step against the loop's step, one batch, the same optimizer
    dp_step = make_dp_train_step(loss_fn, opt)
    (dp_out, dp_ms), got = counted("dp_step", lambda: timed(lambda: dp_step(fresh(opt), (g1, y1), 0)),
                                   costream_step, not_in_step)
    want, _, _, want_loss = loop.train_step(params0, opt.init(params0), ef_init(params0), g1, y1, band1, cfg, opt,
                                            loop_cfg)
    pairs = list(zip(nn.tree_leaves(dp_out[0]["params"]), nn.tree_leaves(want)))
    out["dp_vs_train_step"] = {"leaves": len(pairs), "bitwise_equal": all(torch.equal(a, b) for a, b in pairs),
                               "max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs),
                               "loss": float(dp_out[1]["loss"]), "loss_train_step": float(want_loss),
                               "bound": "bitwise", "step_ms_first": dp_ms, "launches": got}
    if not out["dp_vs_train_step"]["bitwise_equal"] or float(dp_out[1]["loss"]) != float(want_loss):
        emit(out)
        raise AssertionError(f"distributed: the DP step and train_step part ({out['dp_vs_train_step']})")
    del dp_out, want

    # 20 int8-compressed steps on the same batch; the all-reduce alone, timed
    adam = optim.adam(lr=1e-3, max_grad_norm=loop_cfg.max_grad_norm)
    int8_step = make_dp_train_step(loss_fn, adam, compression="int8")
    state, losses, step_ms = fresh(adam), [], []
    for i in range(SIZES["dp_int8_steps"]):
        (state, m), ms = timed(lambda: int8_step(state, (g1, y1), i))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    bufs = [torch.zeros_like(p) for p in nn.tree_leaves(params0)]

    def reduce_all():
        for t in bufs:
            dist.all_reduce(t)

    out["int8"] = {"steps": len(losses), "losses": losses, "step_ms_median": float(np.median(step_ms[1:])),
                   "allreduce_ms_per_step": cuda_ms(reduce_all), "allreduce_leaves": len(bufs),
                   "allreduce_bytes": 4 * sum(t.numel() for t in bufs), "lr": 1e-3}
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        emit(out)
        raise AssertionError(f"distributed: the int8 loss did not fall ({losses[0]} -> {losses[-1]})")
    del state, bufs

    # the pipeline at one stage (K = 1, M = 8) against its stage
    gen = torch.Generator().manual_seed(11)
    W = (torch.randn((1, 256, 256), generator=gen) / 16).to(DEVICE)
    xs = torch.randn((8, 64, 256), generator=gen).to(DEVICE)

    def stage(w, x):
        return torch.tanh(x @ w)

    piped = pipeline_forward(stage)(W, xs)
    direct = torch.stack([stage(W[0], xs[m]) for m in range(xs.shape[0])])
    out["pipeline"] = {"stages": 1, "microbatches": xs.shape[0], "bitwise_equal": bool(torch.equal(piped, direct)),
                       "max_abs_diff": float((piped - direct).abs().max())}
    if not out["pipeline"]["bitwise_equal"]:
        emit(out)
        raise AssertionError("distributed: the one-stage pipeline differs from its stage")

    # elastic: the train phase's stored model (host tensors) re-sharded onto the card
    host, _ = artifacts.load_cost_model("main_latency_p")
    placed = elastic.reshard_state(host, nn.tree_map(lambda _: DEVICE, host))
    leaves = list(zip(nn.tree_leaves(placed), nn.tree_leaves(host)))
    out["elastic"] = {"leaves": len(leaves), "on_device": all(a.device.type == DEVICE for a, _ in leaves),
                      "equal": all(torch.equal(a.cpu(), b) for a, b in leaves)}
    if not (out["elastic"]["on_device"] and out["elastic"]["equal"]):
        emit(out)
        raise AssertionError(f"distributed: reshard_state changed the checkpoint ({out['elastic']})")
    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def split_train_step(cfg, tcfg, state, batch, mark=lambda: None):
    """One ``make_train_step`` step in its three parts, the card synchronized
    between them (the calls ``train_step`` makes): forward (``lm_loss``),
    backward (``autograd.grad``), optimizer (the global norm and
    ``apply_update``).  Returns the new state, the loss and the grad norm,
    the parts' ms, and ``mark()`` read before the step and after each part."""
    import numpy as np
    import torch

    from repro_torch import nn
    from repro_torch.models import steps
    from repro_torch.training import optim

    torch.cuda.synchronize()
    t, marks = [time.perf_counter()], [mark()]
    live = nn.tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    loss = steps.lm_loss(live, cfg, batch)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    marks.append(mark())
    flat = list(torch.autograd.grad(loss, [leaf for _, leaf in nn.tree_leaves_with_paths(live)]))[::-1]
    grads = nn.tree_map(lambda _: flat.pop(), state["params"])  # empties flat: no gradient outlives the step
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    marks.append(mark())
    norm = optim.global_norm(grads)
    params, opt_state = steps.apply_update(tcfg, grads, state["opt"], state["params"], norm)
    new = {"params": params, "opt": opt_state, "step": state["step"] + 1}
    del live, grads, params, opt_state
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    marks.append(mark())
    return new, float(loss.detach()), float(norm), np.diff(t) * 1e3, marks


def lm_train_phase(lm_cfg, weights, counted, cuda_ms, timed, card, costream):
    """RecurrentGemma-2B training on the card through ``make_train_step`` at
    full width and depth (``remat="full"``), from the lm phase's bf16 weights
    (``weights["params"]``, handed over so that the first step can free
    them).  A warm step, counted: every RG-LRU layer's scan launched forward,
    the grouped layers' again in the remat recompute, and each layer's
    reversed scan in the backward; then timed steps split into forward,
    backward and optimizer (synchronized between the parts, the same calls
    ``train_step`` makes), whose loss must fall and whose grad norm must be
    finite.  The step's loss and grad norm with the plain scan against the
    kernel; the scan's backward at the step's shape against the plain VJP."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels.common import oracle_vjp
    from repro_torch.kernels.rglru import ops as scan_ops
    from repro_torch.kernels.rglru.ref import linear_scan_ref
    from repro_torch.models import steps
    from repro_torch.training import optim

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = lm_cfg
    B, S, width = SIZES["lm_train_batch"], SIZES["lm_prompt"], cfg.rnn_width
    n_rec = sum(k == "rec" for k in cfg.pattern) * cfg.n_groups + sum(k == "rec" for k in cfg.suffix)
    # remat recomputes the grouped layers only: the suffix runs outside the groups, as in the JAX package
    n_recomputed = 0 if cfg.remat == "none" else sum(k == "rec" for k in cfg.pattern) * cfg.n_groups
    want = {"forward": n_rec, "recomputed": n_recomputed, "reversed": n_rec}
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(np.int32), device=DEVICE)
    batch = {"tokens": tokens}
    tcfg = steps.TrainStepConfig()
    train_step, opt = steps.make_train_step(cfg, tcfg, device=DEVICE)
    params = weights.pop("params")
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
    del params
    out = {"phase": "lm_train", "card": card, "model": {"arch": cfg.name, "layers": cfg.n_layers(), "rglru_layers": n_rec,
                                                      "remat": cfg.remat, "dtype": "bfloat16", "moments": "float32"},
           "batch": B, "seq": S, "optimizer": dataclasses.asdict(tcfg) | {"moment_dtype": str(tcfg.moment_dtype)}}

    reversed_calls = [0]  # the Function's backward calls linear_scan_bwd once per RG-LRU layer
    real_bwd = scan_ops.linear_scan_bwd

    def counting_bwd(*args):
        reversed_calls[0] += 1
        return real_bwd(*args)

    scan_ops.linear_scan_bwd = counting_bwd
    ((state, m), warm_ms), got = counted("lm_train_step", lambda: timed(lambda: train_step(state, batch)),
                                         ("linear_scan",), costream)
    if got["linear_scan"] != sum(want.values()) or reversed_calls[0] != want["reversed"]:
        emit(out)
        raise AssertionError(f"lm_train: {got['linear_scan']} linear_scan launches ({reversed_calls[0]} reversed), "
                             f"want {want}")
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    parts, launches = [], []
    for _ in range(SIZES["lm_train_steps"]):
        state, loss, norm, ms, c = split_train_step(cfg, tcfg, state, batch,
                                                    lambda: (obs.counters().get("linear_scan.launches", 0),
                                                             reversed_calls[0]))
        parts.append(ms)
        launches.append({"forward": c[1][0] - c[0][0], "backward": c[2][0] - c[1][0], "reversed": c[3][1] - c[0][1]})
        losses.append(loss)
        norms.append(norm)
    fwd, bwd, upd = np.median(np.asarray(parts), axis=0)
    out["step"] = {"forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd, "step_ms": fwd + bwd + upd,
                   "warm_step_ms": warm_ms, "timed_steps": len(parts), "tokens_per_s": B * S / ((fwd + bwd + upd) / 1e3),
                   "linear_scan_launches": {"warm_step": got["linear_scan"], "want": want, "split_steps": launches}}
    out["losses"], out["grad_norms"] = losses, norms
    out["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    out["max_memory_reserved_bytes"] = int(torch.cuda.max_memory_reserved())
    bad = [l for l in launches if l != {"forward": want["forward"], "backward": want["recomputed"] + want["reversed"],
                                        "reversed": want["reversed"]}]
    if bad or not losses[-1] < losses[1] or not all(np.isfinite(norms)):
        emit(out)
        raise AssertionError(f"lm_train: launches {bad}, losses {losses}, grad norms {norms}")

    # one step's loss and grad norm with the plain scan against the kernel, from the same parameters
    def loss_and_norm(c):
        loss, grads = steps.lm_loss_and_grads(state["params"], c, batch)
        return float(loss), float(optim.global_norm(grads))

    (lk, nk), _ = counted("lm_train_loss_kernel", lambda: loss_and_norm(cfg), ("linear_scan",), costream)
    (lp, np_), _ = counted("lm_train_loss_plain", lambda: loss_and_norm(dataclasses.replace(cfg, use_rglru_kernel=False)),
                           (), costream + ("linear_scan",))
    out["kernel_vs_plain_scan"] = {"loss": lk, "loss_plain": lp, "grad_norm": nk, "grad_norm_plain": np_,
                                   "bound_rel": LM_SCAN_REL, "bound_rule": "2**-8 relative: one bf16 rounding"}
    if abs(lk - lp) > LM_SCAN_REL * abs(lp) or abs(nk - np_) > LM_SCAN_REL * abs(np_):
        emit(out)
        raise AssertionError(f"lm_train: the kernel and plain-scan steps part ({out['kernel_vs_plain_scan']})")
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the scan's backward at the step's shape: the Function against the plain VJP
    gen = torch.Generator().manual_seed(5)
    a = torch.rand((B, S, width), generator=gen).to(DEVICE).requires_grad_()
    b, h0g, g = (torch.randn(shape, generator=gen).to(DEVICE) for shape in ((B, S, width), (B, width), (B, S, width)))
    b.requires_grad_()
    h0g.requires_grad_()
    h = scan_ops.linear_scan(a, b, h0g)

    def kernel():
        return torch.autograd.grad(h, (a, b, h0g), g, retain_graph=True)

    def plain():
        return oracle_vjp(types.SimpleNamespace(needs_input_grad=(True, True, True)), linear_scan_ref, g, a, b, h0g)

    got_g, want_g = kernel(), plain()
    errs = [float((x - y).abs().max()) for x, y in zip(got_g, want_g)]
    limits = [TOL * float(y.abs().max()) for y in want_g]
    n = B * S * width
    b_ms, b_by = bound(3.0 * n, 4.0 * 5 * n)  # reads a, g, h; writes lambda and da; a mul-add a step and da's mul
    out["scan_backward"] = {"shape": [B, S, width], "max_abs_err": dict(zip(("da", "db", "dh0"), errs)),
                            "limit": dict(zip(("da", "db", "dh0"), limits)), "rule": "1e-5 x max|plain|",
                            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, reps=2, warmup=1), "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None,
                            "bytes_moved_note": "the flips copy a and g and reverse lambda: three more passes"}
    scan_ops.linear_scan_bwd = real_bwd
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if any(e > l for e, l in zip(errs, limits)):
        raise AssertionError(f"lm_train: the scan's backward disagrees with the plain VJP ({errs} against {limits})")
    return out


def frontend_inputs(cfg, batch, length, dtype, seed, frames=None):
    """A prompt of ``length`` positions on the card: (tokens (batch, T) int32,
    the frontend input).  A vision model's first ``length // 2`` positions
    are seeded patch embeddings (``vis_embeds``), the rest tokens; an
    encoder-decoder's ``length`` tokens come with ``frames`` seeded frames,
    by default ``ENC_LEN``: exactly the decode cache's cross-attention rows
    (fewer leave zero rows that the decoder attends, as in the JAX package)."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import ENC_LEN

    gen = torch.Generator(DEVICE).manual_seed(seed)
    extra = {}
    if cfg.frontend == "vision":
        extra["vis_embeds"] = torch.randn((batch, length // 2, cfg.d_model), generator=gen, device=DEVICE).to(dtype)
        length -= length // 2
    elif cfg.frontend == "audio":
        extra["frames"] = torch.randn((batch, frames or ENC_LEN, cfg.d_model), generator=gen, device=DEVICE).to(dtype)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, length)).astype(np.int32)
    return torch.as_tensor(tokens, device=DEVICE), extra


def fill_cross(w, cfg, cache, frames):
    """A copy of the decode cache ``cache`` whose ``xk`` / ``xv`` hold the
    encoded ``frames`` in their first rows: ``run_encoder``, then one
    ``cross_kv`` per decoder layer, stacked along the layers axis."""
    import torch

    from repro_torch import nn
    from repro_torch.models.blocks import cross_kv
    from repro_torch.models.transformer import run_encoder

    with torch.no_grad():
        enc = run_encoder(w, cfg, frames)
        groups = dict(cache["groups"])
        for i, kind in enumerate(cfg.pattern):
            if kind != "dec":
                continue
            kvs = [cross_kv(nn.tree_map(lambda t: t[g], w["groups"][f"b{i}"]["cross"]), enc, cfg.cross_cfg())
                   for g in range(cfg.n_groups)]
            block = dict(groups[f"b{i}"])
            for key, name in (("xk", "k"), ("xv", "v")):
                new = torch.stack([kv[name] for kv in kvs]).to(block[key].dtype)
                block[key] = torch.cat([new, block[key][:, :, new.shape[2]:]], dim=2)
            groups[f"b{i}"] = block
    return dict(cache, groups=groups)


def lm_prefill(step, w, cfg, cache, tokens, extra):
    """A prompt prefilled into the decode cache as a user of the port does it:
    a vision prompt through ``forward`` with the cache (the serving step takes
    tokens only, as in the JAX package), an encoder-decoder's frames into its
    cross-attention rows (``fill_cross``) and then its tokens through
    ``serve_step``, any other prompt through ``serve_step``.  Returns
    (logits, cache, the greedy next token, the positions now cached)."""
    import torch

    from repro_torch.models.transformer import forward

    if "vis_embeds" in extra:
        with torch.no_grad():
            logits, cache = forward(w, cfg, tokens, vis_embeds=extra["vis_embeds"], cache=cache, cache_len=0)
        return logits, cache, torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None], logits.shape[1]
    if "frames" in extra:
        cache = fill_cross(w, cfg, cache, extra["frames"])
    logits, cache, nxt = step(w, cache, tokens, 0)
    return logits, cache, nxt, tokens.shape[1]


def lm_archs_phase(counted, timed, device_split, aten_ops, card, kernels):
    """Each architecture of ``LM_ARCHS`` served through ``make_serve_step`` on
    the card, one JSON line an architecture.  First one period of its layer
    pattern (a dense prefix once; whisper one encoder and one decoder group)
    at the published widths in float32: the cached path (a prefill, then
    greedy decode steps) against the uncached ``forward`` of the same
    prompt within ``LM_RTOL``.  Then the reduced config in float32, card
    against CPU: the uncached forward, a prefill and decode steps with every
    cache leaf.  Then random bf16 weights at the published widths, cut in
    depth as ``LM_ARCHS`` says: a prefill of ``archs_batch`` prompts into the
    cache (``lm_prefill``; internvl2: 1024 patch embeddings and 1024 tokens,
    whisper: 1500 frames encoded, then a 64-token prompt into a 448-position
    cache) and ``archs_decode`` greedy decode steps, timed, profiled and
    checked for finite logits of the right shape.  None of ``kernels`` may
    launch on any of these paths."""
    import numpy as np
    import torch

    from repro_torch import nn
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.params import count_params, materialize
    from repro_torch.models.steps import make_serve_step
    from repro_torch.models.transformer import forward, model_cache_defs, model_defs

    dev = torch.device(DEVICE)
    B, n_dec = SIZES["archs_batch"], SIZES["archs_decode"]
    out = []

    def quiet(path, fn):
        return counted(path, fn, (), kernels)[0]

    def leaves(tree):
        return [leaf for _, leaf in nn.tree_leaves_with_paths(tree)]

    def max_diff(pairs):
        return max(float((a.float().cpu() - b.float().cpu()).abs().max()) for a, b in pairs)

    def agree(pairs):
        return all(torch.allclose(a.cpu(), b.cpu(), rtol=LM_RTOL, atol=LM_RTOL) for a, b in pairs)

    def well_formed(what, logits, shape):
        if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"lm_archs {what}: logits {tuple(logits.shape)} (want {shape}), or non-finite values")

    for arch, cut in LM_ARCHS.items():
        t_arch = time.perf_counter()
        published = get_config(arch)
        full = reduced(published) if SIZES["lm_reduced"] else published  # a CPU dry run of the control flow
        moe = full.moe is not None
        rec = {"phase": "lm_archs", "arch": arch, "card": card}

        # 1. one period at full width in float32: cached against uncached.  Each sequence is
        # a MoE dispatch group whose capacity max(k, int(capacity_factor k S / E)) depends
        # on its length S, so at the published factor a decode step (S = 1, nothing dropped)
        # may differ from the long uncached forward's position.  A factor of E / k gives
        # capacity S: no pair is dropped on either path, and every decode step is held.
        period = dataclasses.replace(full, n_groups=1, enc_groups=min(full.enc_groups, 1))
        if moe:
            period = dataclasses.replace(
                period, moe=dataclasses.replace(full.moe, capacity_factor=full.moe.n_experts / full.moe.top_k))
        P, n = SIZES["archs_check_prompt"], SIZES["archs_check_decode"]
        torch.cuda.reset_peak_memory_stats()
        w = materialize(torch.Generator(DEVICE).manual_seed(1), model_defs(period), torch.float32, DEVICE)
        toks, extra = frontend_inputs(period, B, P, torch.float32, 1)
        step = make_serve_step(period, device=DEVICE)

        def check():
            empty = materialize(None, model_cache_defs(period, B, P + n), torch.float32, DEVICE)
            lg, cache, nxt, pos = lm_prefill(step, w, period, empty, toks, extra)
            got, fed = [lg], []
            for i in range(n):
                fed.append(nxt)
                lg, cache, nxt = step(w, cache, nxt, pos + i)
                got.append(lg)
            with torch.no_grad():
                want, _ = forward(w, period, torch.cat([toks, torch.cat(fed, 1)], 1), **extra)
            pairs = [(g, want[:, pos + i : pos + i + 1]) for i, g in enumerate(got[1:])]
            if full.xlstm is None:
                pairs.append((got[0], want[:, :pos]))
            # xLSTM: a fresh cache starts the stabilizer m at 0 where the uncached forward
            # starts it at -1e30, and the denominator max(|n . q|, 1) then differs at the
            # first positions (the JAX package's semantics); the forget gates decay that
            # start away, so the decode steps past the prompt are held, the prefill not
            return pairs

        pairs = quiet(f"lm_archs_check:{arch}", check)
        rec["full_width_fp32"] = {
            "layers": period.n_layers(), "params": count_params(model_defs(period)), "prompt": P, "decode_steps": n,
            **{k: v.shape[1] for k, v in extra.items()},
            "compared": "decode steps" if full.xlstm else "prefill and decode steps",
            "capacity_factor": period.moe.capacity_factor if moe else None,
            "max_abs_err": max_diff(pairs), "max_abs_logit": max(float(b.abs().max()) for _, b in pairs),
            "rtol_atol": LM_RTOL, "ok": agree(pairs), "peak_bytes": int(torch.cuda.max_memory_allocated())}
        del w, pairs, step, extra
        torch.cuda.empty_cache()

        # 2. the reduced config in float32, card against CPU (vision: 6 patch embeddings
        # and 6 tokens; whisper: 12 tokens over 16 frames, whose sinusoid angles stay
        # small: the card's and the host's exp may round a frequency apart, and an
        # angle of 1500 rad moves 1500 times that)
        r_cfg = reduced(published)
        r_cpu = materialize(torch.Generator().manual_seed(1), model_defs(r_cfg), torch.float32, "cpu")
        r_dev = nn.to_device(r_cpu, dev)
        r_toks, r_extra = frontend_inputs(r_cfg, 2, 12, torch.float32, 1, frames=16)
        r_host = (r_toks.cpu(), {k: v.cpu() for k, v in r_extra.items()})

        def reduced_pairs():
            with torch.no_grad():
                want, _ = forward(r_cpu, r_cfg, r_host[0], **r_host[1])
                got, _ = forward(r_dev, r_cfg, r_toks, **r_extra)
            pairs = [(got, want)]
            runs = {}  # device -> [weights, step, logits, cache, next token]: a 12-position prefill
            for d, w_, (t_, e_) in (("cpu", r_cpu, r_host), (DEVICE, r_dev, (r_toks, r_extra))):
                step_ = make_serve_step(r_cfg, device=d)
                lg, cache, nxt, pos = lm_prefill(step_, w_, r_cfg, materialize(None, model_cache_defs(r_cfg, 2, 24),
                                                                                torch.float32, d), t_, e_)
                runs[d] = [w_, step_, lg, cache, nxt]
            for i in range(7):  # the prefill, then 6 decode steps, the card fed the CPU's greedy tokens
                if i:
                    nxt = runs["cpu"][4]
                    for run in runs.values():
                        run[2], run[3], run[4] = run[1](run[0], run[3], nxt, pos)
                    pos += 1
                card, host = runs[DEVICE], runs["cpu"]
                pairs += list(zip([card[2]] + leaves(card[3]), [host[2]] + leaves(host[3])))
            return pairs

        pairs = quiet(f"lm_archs_reduced:{arch}", reduced_pairs)
        rec["reduced_card_vs_cpu"] = {"layers": r_cfg.n_layers(), "max_abs_err": max_diff(pairs), "rtol_atol": LM_RTOL,
                                      "ok": agree(pairs)}
        del r_cpu, r_dev, pairs

        # 3. bf16 at the published widths, cut in depth: prefill, then greedy decode
        cfg = full if cut is None else dataclasses.replace(full, n_groups=min(cut, full.n_groups))
        defs = model_defs(cfg)
        P = SIZES["whisper_prompt"] if cfg.enc_pattern else max(SIZES["archs_prompt"], cfg.window or 0)
        max_seq = SIZES["whisper_context"] if cfg.enc_pattern else P + n_dec
        rec["model"] = {"layers": cfg.n_layers(), "layers_published": published.n_layers(),
                        "params": count_params(defs), "params_published": count_params(model_defs(published)),
                        "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": "bfloat16",
                        "cut": None if cut is None else f"{cfg.n_groups} of {published.n_groups} groups of {cfg.pattern}"
                        + (f" after the prefix {cfg.prefix}" if cfg.prefix else "")}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        w = materialize(torch.Generator(DEVICE).manual_seed(0), defs, device=DEVICE)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        prompts, extra = frontend_inputs(cfg, B, P, torch.bfloat16, 0)
        rec.update({"requests": B, "prompt": P, **{k: v.shape[1] for k, v in extra.items()},
                    "decode_steps": n_dec, "max_seq": max_seq})
        step = make_serve_step(cfg, device=DEVICE)
        empty = materialize(None, model_cache_defs(cfg, B, max_seq), device=DEVICE)

        def prefill(upto=None):
            return lm_prefill(step, w, cfg, empty, prompts[:, :upto], extra)

        (logits, prefilled, first, pos), rec["prefill_ms_first"] = quiet(f"lm_archs_prefill:{arch}",
                                                                         lambda: timed(prefill))
        well_formed(f"{arch} prefill", logits, (B, pos, cfg.vocab))
        del logits
        rec["prefill_ms"] = quiet(f"lm_archs_prefill:{arch}", lambda: timed(prefill))[1]
        if extra.get("frames") is not None:  # the encoder and the cross-attention rows alone
            rec["encode_ms"] = quiet(f"lm_archs_prefill:{arch}",
                                     lambda: timed(lambda: fill_cross(w, cfg, empty, extra["frames"])))[1]
        # an xLSTM prefill is a time loop of some 250 kernels a position; the profiler
        # reads 2048 positions' worth for minutes, so its split is taken over the
        # fp32 check's prompt length: the same loop, shorter
        rec["prefill_profile_prompt"] = P if full.xlstm is None else SIZES["archs_check_prompt"]
        rec["prefill_profile"] = device_split(lambda: prefill(rec["prefill_profile_prompt"]))
        cache, tok, dec_ms = prefilled, first, []
        for i in range(n_dec):
            (lg, cache, tok), ms = quiet(f"lm_archs_decode:{arch}", lambda: timed(lambda: step(w, cache, tok, pos + i)))
            well_formed(f"{arch} decode step {i}", lg, (B, 1, cfg.vocab))
            dec_ms.append(ms)
        rest = dec_ms[1:] or dec_ms
        rec["decode_ms_first"] = dec_ms[0]
        rec["decode_ms"] = {"mean": float(np.mean(rest)), "min": min(rest), "max": max(rest), "steps": len(rest)}
        rec["tokens_per_s"] = {"prefill": B * P / (rec["prefill_ms"] / 1e3), "decode": B / (rec["decode_ms"]["mean"] / 1e3)}
        rec["last_position"] = pos + n_dec - 1
        rec["decode_profile"] = device_split(lambda: step(w, prefilled, first, pos))
        rec["decode_aten_ops"] = aten_ops(lambda: step(w, prefilled, first, pos))
        rec["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
        del w, empty, prefilled, cache, lg, step, extra
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_arch
        emit(rec)
        out.append(rec)
        bad = [k for k in ("full_width_fp32", "reduced_card_vs_cpu") if not rec[k]["ok"]]
        if bad:
            raise AssertionError(f"lm_archs {arch}: {bad} disagree ({[rec[k]['max_abs_err'] for k in bad]})")
    return out


def lm_archs_train_phase(counted, timed, card, kernels):
    """Each architecture of ``LM_ARCHS_TRAIN`` trained through
    ``make_train_step`` on the card, one JSON line an architecture.  First the
    reduced config in float32: 3 steps on the card against the same 3 on the
    CPU, loss and grad norm within ``LM_RTOL``.  Then random bf16 weights at
    the published widths, cut in depth as ``LM_ARCHS_TRAIN`` says, the
    config's own remat (``"full"``), Adam with float32 moments, a batch of
    ``archs_train_batch`` sequences (internvl2: 1024 patch embeddings and
    1024 tokens; whisper: 1500 frames and 448 tokens): a warm step, then
    ``archs_train_steps`` steps split into forward, backward and optimizer
    (``split_train_step``), each loss and grad norm finite; tokens/s and peak
    memory.  None of ``kernels`` may launch on any of these paths."""
    import numpy as np
    import torch

    from repro_torch import nn
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import steps
    from repro_torch.models.params import count_params, materialize
    from repro_torch.models.transformer import model_defs

    B, n_steps = SIZES["archs_train_batch"], SIZES["archs_train_steps"]
    tcfg = steps.TrainStepConfig()
    out = []

    def quiet(path, fn):
        return counted(path, fn, (), kernels)[0]

    def fresh(cfg, params, device):
        step, opt = steps.make_train_step(cfg, tcfg, device=device)
        return step, {"params": params, "opt": opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32, device=device)}

    def close(a, b):
        return abs(a - b) <= LM_RTOL + LM_RTOL * abs(b)

    for arch, (groups, seq) in LM_ARCHS_TRAIN.items():
        t_arch = time.perf_counter()
        published = get_config(arch)
        full = reduced(published) if SIZES["lm_reduced"] else published  # a CPU dry run of the control flow
        rec = {"phase": "lm_archs_train", "arch": arch, "card": card,
               "optimizer": dataclasses.asdict(tcfg) | {"moment_dtype": str(tcfg.moment_dtype)}}

        # 1. the reduced config in float32: 3 steps on the card against the CPU
        r_cfg = reduced(published)
        r_params = materialize(torch.Generator().manual_seed(2), model_defs(r_cfg), torch.float32, "cpu")
        toks, extra = frontend_inputs(r_cfg, 2, 16, torch.float32, 2, frames=16)
        r_batch = {"tokens": toks, **extra}

        def reduced_runs():
            runs = {}
            for d in ("cpu", DEVICE):
                step, state = fresh(r_cfg, nn.to_device(r_params, torch.device(d)), d)
                batch = {k: v.to(d) for k, v in r_batch.items()}
                runs[d] = []
                for _ in range(3):
                    state, m = step(state, batch)
                    runs[d].append([float(m["loss"]), float(m["grad_norm"])])
            return runs["cpu"], runs[DEVICE]

        cpu, got = quiet(f"lm_archs_train_reduced:{arch}", reduced_runs)
        rec["reduced_card_vs_cpu"] = {
            "layers": r_cfg.n_layers(), "steps": 3, "loss": [g[0] for g in got], "loss_cpu": [c[0] for c in cpu],
            "grad_norm": [g[1] for g in got], "grad_norm_cpu": [c[1] for c in cpu], "rtol_atol": LM_RTOL,
            "ok": all(close(a, b) for g, c in zip(got, cpu) for a, b in zip(g, c))}
        del r_params

        # 2. bf16 at the published widths, cut in depth
        if isinstance(groups, str):
            rec["model"] = {"layers_published": published.n_layers(), "params_published":
                            count_params(model_defs(published)), "trained": False, "cut": groups}
        else:
            cfg = full if groups is None else dataclasses.replace(full, n_groups=min(groups, full.n_groups))
            defs = model_defs(cfg)
            rec["model"] = {"layers": cfg.n_layers(), "layers_published": published.n_layers(),
                            "params": count_params(defs), "params_published": count_params(model_defs(published)),
                            "remat": cfg.remat, "dtype": "bfloat16", "trained": True,
                            "cut": None if groups is None else
                            f"{cfg.n_groups} of {published.n_groups} groups of {cfg.pattern}"
                            + (f" after the prefix {cfg.prefix}" if cfg.prefix else "")}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_step, state = fresh(cfg, materialize(torch.Generator(DEVICE).manual_seed(0), defs, device=DEVICE),
                                      DEVICE)
            torch.cuda.synchronize()
            rec["init_s"] = time.perf_counter() - t0
            S = seq or SIZES["archs_train_seq"]
            toks, extra = frontend_inputs(cfg, B, S, torch.bfloat16, 0)
            batch = {"tokens": toks, **extra}
            positions = toks.shape[1] + (extra["vis_embeds"].shape[1] if "vis_embeds" in extra else 0)
            rec.update({"batch": B, "tokens": toks.shape[1], "positions": positions,
                        **{k: v.shape[1] for k, v in extra.items()}})
            (state, m), warm_ms = quiet(f"lm_archs_train_step:{arch}", lambda: timed(lambda: train_step(state, batch)))
            losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
            del m

            def split_steps():
                nonlocal state
                parts = []
                for _ in range(n_steps):
                    state, loss, norm, ms, _ = split_train_step(cfg, tcfg, state, batch)
                    parts.append(ms)
                    losses.append(loss)
                    norms.append(norm)
                return parts

            parts = quiet(f"lm_archs_train_step:{arch}", split_steps)
            fwd, bwd, upd = np.median(np.asarray(parts), axis=0)
            step_s = (fwd + bwd + upd) / 1e3
            rec["step"] = {"forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd, "step_ms": step_s * 1e3,
                           "warm_step_ms": warm_ms, "timed_steps": len(parts),
                           "tokens_per_s": B * toks.shape[1] / step_s, "positions_per_s": B * positions / step_s}
            rec["losses"], rec["grad_norms"] = losses, norms
            rec["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
            rec["max_memory_reserved_bytes"] = int(torch.cuda.max_memory_reserved())
            del state, batch, extra, train_step
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
                emit(rec)
                raise AssertionError(f"lm_archs_train {arch}: losses {losses}, grad norms {norms}")
        rec["seconds"] = time.perf_counter() - t_arch
        emit(rec)
        out.append(rec)
        if not rec["reduced_card_vs_cpu"]["ok"]:
            raise AssertionError(f"lm_archs_train {arch}: the reduced steps on the card and the CPU part "
                                 f"({rec['reduced_card_vs_cpu']})")
    return out


#: The dryrun phase's cells: the hillclimb's three on the single-pod mesh
#: (launch/hillclimb.py), each run as it is before the variants that its
#: function of ``hillclimb`` then runs: name -> (arch, shape, function).
DRYRUN_BASELINES = {"A0_baseline": ("qwen3-8b", "train_4k", "cell_a"),
                    "B0_baseline": ("deepseek-v2-236b", "decode_32k", "cell_b"),
                    "C0_baseline": ("recurrentgemma-2b", "prefill_32k", "cell_c")}
# A step's compute term is the least time its FLOPs take at the card's bf16
# peak; a measured time below it by more than timing noise is impossible.
COMPUTE_TERM_MAX_SHARE = 1.05


def measured_steps():
    """The LM steps that the lm, lm_archs and lm_archs_train phases time, at
    their cuts and shapes: one dict each (phase, arch, layer groups, kind,
    batch, tokens, cache length, patch embeddings, frames)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import ENC_LEN

    def frontend(arch, length):
        cfg = get_config(arch)
        if cfg.frontend == "vision":
            return {"tokens": length - length // 2, "vis": length // 2, "frames": 0}
        return {"tokens": length, "vis": 0, "frames": ENC_LEN if cfg.frontend == "audio" else 0}

    out = [{"phase": "lm", "arch": "recurrentgemma-2b", "groups": None, "kind": "prefill", "batch": SIZES["lm_batch"],
            "tokens": SIZES["lm_prompt"], "vis": 0, "frames": 0, "max_seq": SIZES["lm_prompt"] + SIZES["lm_decode"]}]
    for arch, cut in LM_ARCHS.items():
        cfg = get_config(arch)
        P = SIZES["whisper_prompt"] if cfg.enc_pattern else max(SIZES["archs_prompt"], cfg.window or 0)
        max_seq = SIZES["whisper_context"] if cfg.enc_pattern else P + SIZES["archs_decode"]
        out.append({"phase": "lm_archs", "arch": arch, "groups": cut, "kind": "prefill", "batch": SIZES["archs_batch"],
                    **frontend(arch, P), "max_seq": max_seq})
    for arch, (groups, seq) in LM_ARCHS_TRAIN.items():
        if not isinstance(groups, str):
            out.append({"phase": "lm_archs_train", "arch": arch, "groups": groups, "kind": "train",
                        "batch": SIZES["archs_train_batch"], **frontend(arch, seq or SIZES["archs_train_seq"]),
                        "max_seq": None})
    return out


def dryrun_counts(request_path, out_path):
    """A share of the dryrun phase's work, in a process of its own (the
    distributed phase holds an NCCL default group; the dry run makes a fake
    one): the request's hillclimb baseline and its variants on the
    single-pod 16 x 16 mesh, if it names one, then each of its measured steps
    counted on one GPU at its cut and shape: plain meta tensors and no mesh,
    the card's own code path.  Nothing runs on the card.  Writes
    {"cells": {...}, "steps": [...]} to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.roofline import terms_from_counter
    from repro_torch.models.params import abstract
    from repro_torch.models.steps import TrainStepConfig, make_serve_step, make_train_step
    from repro_torch.models.transformer import model_cache_defs, model_defs

    with open(request_path) as f:
        request = json.load(f)
    cells = {}
    if request["baseline"]:
        arch, shape, climb = DRYRUN_BASELINES[request["baseline"]]
        cells[request["baseline"]] = dryrun.run_cell(arch, shape, False, save=False)
        cells.update(getattr(hillclimb, climb)())

    tcfg = TrainStepConfig()

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    steps = []
    for spec in request["steps"]:
        t0 = time.perf_counter()
        cfg = get_config(spec["arch"])
        cfg = reduced(cfg) if request["reduced"] else cfg
        if spec["groups"] is not None:
            cfg = dataclasses.replace(cfg, n_groups=min(spec["groups"], cfg.n_groups))
        params = abstract(model_defs(cfg))
        B = spec["batch"]

        def build(n):
            """(fn, args) of the step with ``n`` tokens."""
            batch = {"tokens": meta((B, n), torch.int32)}
            if spec["vis"]:
                batch["vis_embeds"] = meta((B, spec["vis"], cfg.d_model), torch.bfloat16)
            if spec["frames"]:
                batch["frames"] = meta((B, spec["frames"], cfg.d_model), torch.bfloat16)
            if spec["kind"] == "train":
                return make_train_step(cfg, tcfg, device="meta")[0], (dryrun.train_state(params, tcfg), batch)
            cache = abstract(model_cache_defs(cfg, B, spec["max_seq"]))
            step = make_serve_step(cfg, device="meta")
            toks = batch.pop("tokens")
            return (lambda w, c, t, extra: lm_prefill(step, w, cfg, c, t, extra)), (params, cache, toks, batch)

        if dryrun.time_loop(cfg):
            c, _, meta_rec = dryrun.extrapolate_in_time(lambda n: dryrun.count_call(*build(n), None), spec["tokens"])
            args_b = dryrun.local_bytes(build(spec["tokens"])[1])
        else:
            c, args_b, _ = dryrun.count_call(*build(spec["tokens"]), None)
            meta_rec = None
        terms = terms_from_counter(c, 0.0)
        steps.append({**spec, "layers": cfg.n_layers(), "flops": c.flops, "bytes": c.bytes, "t_compute_s": terms.t_compute,
                      "t_memory_s": terms.t_memory, "argument_bytes": args_b, "temp_bytes": c.temp_peak,
                      "predicted_peak_bytes": args_b + c.temp_peak, "kernels": c.kernels,
                      "extrapolated": meta_rec, "count_s": time.perf_counter() - t0})
    with open(out_path, "w") as f:
        json.dump({"cells": cells, "steps": steps}, f, default=str)
    return 0


#: The examples phase's train_lm run: the real 125M config that the JAX
#: script's docstring names, a crash injected after a step that follows a
#: checkpoint, then the restart, against an uninterrupted run of the same steps.
TRAIN_LM_STEPS = 6
TRAIN_LM_FLAGS = ("--arch", "xlstm-125m", "--scale", "full", "--steps", str(TRAIN_LM_STEPS), "--ckpt-every", "2")
TRAIN_LM_CRASH_AT = 3


def examples_phase(counted, card):
    """The port's five examples (``repro_torch.examples``) through their
    ``main(argv)`` on the card, one line each with its time, peak memory and
    the launches of the six kernels: ``quickstart``, ``optimize_placement`` and
    ``controller_demo`` at their defaults (not ``--smoke``), ``serve_lm`` at its
    default (the reduced ``recurrentgemma-2b``, whose RG-LRU scan launches
    ``linear_scan``), and ``train_lm`` at ``TRAIN_LM_FLAGS``: a run that
    exits 17 after step ``TRAIN_LM_CRASH_AT``, the restart from its newest
    checkpoint, and an uninterrupted run, whose losses the restart must match
    within ``TRAJ_REL``.  Each example's own output goes to a log under
    ``build/``; the phase fails if one raises, returns non-finite values or
    does not launch what its path launches."""
    import contextlib
    import math

    import torch

    from repro_torch.examples import controller_demo, optimize_placement, quickstart, serve_lm, train_lm

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    where = Path(tempfile.mkdtemp(prefix="examples_", dir=ROOT / "build"))
    costream = ("banked_mlp", "mp_update", "mp_sweep", "gather_sum", "segment_sum")
    dev = ["--device", DEVICE]
    out = {"phase": "examples", "card": card, "runs": {}}

    def run(name, fn, argv, need=(), never=costream + ("linear_scan",)):
        """``fn(argv)`` with its output to ``where/<name>.log``, counted; its
        result and a record of time, peak memory and launches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with open(where / f"{name}.log", "a") as log, contextlib.redirect_stdout(log):
            got, launches = counted(f"examples_{name}", lambda: fn(argv), need, never)
        rec = {"argv": argv, "seconds": time.perf_counter() - t0,
               "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()), "launches": launches}
        return got, rec

    def finite(*xs):
        return all(math.isfinite(float(x)) for x in xs)

    # quickstart's stream goes through PlacementService's merged cross-query
    # forward, which runs seg_gather whatever use_pallas says; its model, as
    # the JAX script configures it, runs the other kernels' plain versions
    got, rec = run("quickstart", quickstart.main, dev, need=("gather_sum", "segment_sum"),
                   never=("banked_mlp", "mp_update", "mp_sweep", "linear_scan"))
    rec.update(corpus=got["corpus"], epochs=got["epochs"], best_val=got["best_val"], qerror=got["qerror"],
               stream=got["stream"])
    out["runs"]["quickstart"] = rec
    if not (finite(got["best_val"], *[q["predicted_ms"] for q in got["queries"]], *got["stream"]["best"])
            and got["stream"]["forwards"] >= 1):
        emit(out)
        raise AssertionError(f"examples: quickstart returned {got}")

    got, rec = run("optimize_placement", optimize_placement.main, dev)
    rec.update(queries=len(got["queries"]), median_speedup=got["median_speedup"],
               candidates_per_s=got["candidates_per_s"])
    out["runs"]["optimize_placement"] = rec
    if not (got["queries"] and finite(*[q["costream_ms"] for q in got["queries"]], got["median_speedup"])):
        emit(out)
        raise AssertionError(f"examples: optimize_placement returned {got}")

    got, rec = run("controller_demo", controller_demo.main, dev)
    rec.update({k: got[k] for k in ("final_cost_ms", "static_final_cost_ms", "ratio", "migrations", "replans",
                                    "replan_p95_ms")})
    out["runs"]["controller_demo"] = rec  # main raises unless the controller beats the static fleet

    got, rec = run("serve_lm", serve_lm.main, dev, need=("linear_scan",), never=costream)
    rec.update({k: got[k] for k in ("arch", "params", "batch", "tokens", "tokens_per_s", "logits_finite")})
    out["runs"]["serve_lm"] = rec
    if not got["logits_finite"]:
        emit(out)
        raise AssertionError("examples: serve_lm's logits are not finite")

    flags = [*TRAIN_LM_FLAGS, *dev]
    crash_dir, whole_dir = str(where / "ckpt_crash"), str(where / "ckpt_whole")

    def crash(argv):
        try:
            train_lm.main(argv)
        except SystemExit as e:
            return e.code
        return None

    code, rec_crash = run("train_lm", crash, flags + ["--ckpt-dir", crash_dir, "--inject-failure", str(TRAIN_LM_CRASH_AT)])
    resumed, rec_resume = run("train_lm", train_lm.main, flags + ["--ckpt-dir", crash_dir])
    whole, rec_whole = run("train_lm", train_lm.main, flags + ["--ckpt-dir", whole_dir])
    rel = {s: abs(resumed["losses"][s] - whole["losses"][s]) / abs(whole["losses"][s]) for s in resumed["losses"]}
    out["runs"]["train_lm"] = {
        "arch": whole["arch"], "params": whole["params"], "crash": {**rec_crash, "exit": code},
        "resume": {**rec_resume, "resumed_from": resumed["resumed_from"], "losses": resumed["losses"]},
        "uninterrupted": {**rec_whole, "losses": whole["losses"], "grad_norms": whole["grad_norms"]},
        "max_rel_loss_diff": max(rel.values(), default=None), "bound": f"{TRAJ_REL} relative (TRAJ_REL)"}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if (code != 17 or resumed["resumed_from"] is None or sorted(resumed["losses"]) != list(
            range(resumed["resumed_from"] + 1, TRAIN_LM_STEPS)) or not finite(*whole["losses"].values())
            or max(rel.values()) > TRAJ_REL):
        raise AssertionError(f"examples: train_lm's restart (exit {code}, from {resumed['resumed_from']}) "
                             f"differs from the uninterrupted run: {rel}")
    shutil.rmtree(where, ignore_errors=True)


#: The extrap parity check.  Each extrap run on the card is held against the
#: same run (corpus, init, batch order) on the CPU plain path, epoch by epoch.
#: The kernels differ from the plain versions by rounding, about 1e-6 of a
#: state at every forward (TRAJ_REL's derivation above).  Where a run's
#: training amplifies rounding (400 traces, one step a signature bucket, the
#: loss swinging between 1e-9 and 14), it amplifies any perturbation of that
#: size alike, and may settle on another of a few nearby outcomes (a unit's
#: ReLU gate closing for good or not): on a CPU, one run at 150 traces ended
#: 0.8% apart on one and on two threads.  So the CPU trains each run again
#: EXTRAP_PERTURB_RUNS times with every parameter multiplied by 1 +- 1e-6
#: (EXTRAP_PERTURB, seeded signs) before each step, and the card's validation
#: loss must lie within TRAJ_REL of the reference's plus twice the largest
#: distance of those perturbed runs from it: a run that does not amplify
#: rounding is held to TRAJ_REL, one that does to what its own plain
#: reference does under kernel-sized rounding.  EXTRAP_CPU_PROCS child
#: processes share the runs.
EXTRAP_PERTURB = 1e-6
EXTRAP_PERTURB_RUNS = 3
EXTRAP_CPU_PROCS = 4


def extrap_cpu(where, part, parts):
    """The ``extrap_cpu`` child: runs ``part::parts`` of the 40 extrap runs on
    the CPU plain path, from the corpora the card's stage built (copied to
    ``where`` with the epochs in ``request.json``), each as
    ``launch/train.py``'s ``_train_one`` trains it, and again with
    kernel-sized perturbations (``EXTRAP_PERTURB``); writes each run's
    validation losses to ``where/<part>.json``."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import nn
    from repro_torch.core import gnn
    from repro_torch.core.model import ALL_METRICS, CostModelConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.training import batching, loop

    torch.set_num_threads(1)
    with open(where / "request.json") as f:
        epochs = json.load(f)["epochs"]
    runs = [(d, m, metric) for d in ("stronger", "weaker") for m in ("ram", "cpu", "bandwidth", "latency")
            for metric in ALL_METRICS][part::parts]
    step = loop.train_step
    out = {}
    for direction, dim, metric in runs:
        with open(where / f"extrap_{direction}_{dim}.torch.pkl", "rb") as f:
            traces = pickle.load(f)
        tr, va, _ = batching.split_dataset(batching.dataset_from_traces(traces, metric), seed=launch_train.SPLIT_SEED)
        cfg = CostModelConfig(metric=metric, gnn=gnn.GNNConfig(use_pallas=True), n_ensemble=1)
        tcfg = loop.TrainConfig(epochs=epochs, batch_size=512, lr=1.5e-3, seed=0, exact_banding=True)
        rec = {}
        for seed in (None, *range(1, EXTRAP_PERTURB_RUNS + 1)):
            if seed is None:
                loop.train_step = step
            else:
                gen = torch.Generator().manual_seed(seed)

                def perturbed(params, *args, gen=gen):
                    params = nn.tree_map(lambda t: t * (1 + EXTRAP_PERTURB * (
                        2 * torch.randint(0, 2, t.shape, generator=gen) - 1)), params)
                    return step(params, *args)

                loop.train_step = perturbed
            res = loop.train_cost_model(tr, va, cfg, tcfg, device="cpu")
            rec["reference" if seed is None else f"perturbed_{seed}"] = [h["val_loss"] for h in res.history]
        loop.train_step = step
        out[f"extrap_{direction}_{dim}_{metric}"] = rec
    with open(where / f"{part}.json", "w") as f:
        json.dump(out, f)
    return 0


def start_extrap_cpu(where):
    """Start ``EXTRAP_CPU_PROCS`` ``extrap_cpu`` children on the host CPU."""
    procs = []
    for i in range(EXTRAP_CPU_PROCS):
        with open(where / f"{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--extrap-cpu", str(where), str(i),
                 str(EXTRAP_CPU_PROCS)], stdout=log, stderr=subprocess.STDOUT))
    return procs


def extrap_parity_phase(procs, where, card_runs, card):
    """The extrap runs' validation losses on the card against the CPU plain
    path (``extrap_cpu``), epoch by epoch, within TRAJ_REL plus twice the
    larger distance of the perturbed CPU runs from the reference; one line
    with every run's numbers.  Fails if a child failed or a run is outside."""
    t0 = time.perf_counter()
    cpu = {}
    for i, proc in enumerate(procs):
        rc = proc.wait(timeout=900)
        if rc != 0:
            print((where / f"{i}.log").read_text()[-6000:], file=sys.stderr)
            raise AssertionError(f"extrap_parity: child process {i} exited {rc}")
        with open(where / f"{i}.json") as f:
            cpu.update(json.load(f))
    runs, bad = {}, []
    for name, got in card_runs.items():
        ref = cpu[name]["reference"]
        pert = [cpu[name][k] for k in cpu[name] if k != "reference"]
        if len(ref) != len(got["val_loss"]):
            bad.append(f"{name}: {len(got['val_loss'])} epochs on the card, {len(ref)} on the CPU")
            continue
        rows = []
        for e, (c, a) in enumerate(zip(got["val_loss"], ref)):
            spread = max(abs(p[e] - a) for p in pert)
            bound = TRAJ_REL * abs(a) + 2.0 * spread
            rows.append({"card": c, "cpu": a, "rel": abs(c - a) / abs(a), "perturbed_rel": spread / abs(a),
                         "bound_rel": bound / abs(a)})
            if not abs(c - a) <= bound:
                bad.append(f"{name} epoch {e}: card {c}, cpu {a}, bound {bound}")
        runs[name] = {"epochs": rows, "val_at_init": got["val_at_init"], "best_val": got["best_val"],
                      "cpu_best_below_init": min(ref) < got["val_at_init"]}
    rel = [r["rel"] for v in runs.values() for r in v["epochs"]]
    emit({"phase": "extrap_parity", "card": card, "runs": len(runs), "children": len(procs),
          "bound": f"|card - cpu| <= {TRAJ_REL} |cpu| + 2 max |perturbed - cpu| ({EXTRAP_PERTURB_RUNS} runs, "
                   f"params x (1 +- {EXTRAP_PERTURB}) before each step)",
          "max_rel": max(rel, default=None), "median_rel": float(sorted(rel)[len(rel) // 2]) if rel else None,
          "above_traj_rel": sum(r > TRAJ_REL for r in rel),
          "below_init_on_card": sum(v["best_val"] < v["val_at_init"] for v in runs.values()),
          "below_init_on_cpu": sum(v["cpu_best_below_init"] for v in runs.values()),
          "wait_s": time.perf_counter() - t0, "per_run": runs})
    if bad or len(runs) != len(cpu):
        raise AssertionError(f"extrap_parity: {bad or sorted(set(cpu) ^ set(runs))}")


def start_dryrun(where):
    """Start ``dryrun_counts`` in five child processes side by side, on the
    host CPU: one for each hillclimb baseline with its variants, and two for
    the measured steps (those with a time loop apart: they take longest to
    count).  Each one's request, counts and log are ``where/<i>.*``, its
    artifacts under ``where/artifacts``.  The processes, in that order."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import time_loop

    steps = measured_steps()
    looped = [time_loop(get_config(s["arch"])) for s in steps]
    requests = [{"baseline": name, "steps": []} for name in DRYRUN_BASELINES]
    requests += [{"baseline": None, "steps": [s for s, t in zip(steps, looped) if t == want]} for want in (False, True)]
    procs = []
    for i, req in enumerate(requests):
        with open(where / f"{i}.request.json", "w") as f:
            json.dump({**req, "reduced": SIZES["lm_reduced"]}, f)
        with open(where / f"{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dryrun-counts", str(where / f"{i}.request.json"),
                 str(where / f"{i}.counts.json")], stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, REPRO_ARTIFACTS=str(where / "artifacts"))))
    return procs


def dryrun_phase(lm, archs, archs_train, card, n_rec, lm_width):
    """The dry run's results: one line a hillclimb cell (the three terms on
    H100 data-sheet constants, the bottleneck, per-GPU memory), each of which
    must end ``ok``; then each measured LM step beside its count on one GPU
    (compute and memory terms, their share of the measured ms, the predicted
    peak against ``max_memory_allocated``).  Fails if the child failed, if a
    compute term passes ``COMPUTE_TERM_MAX_SHARE`` x the measured time, or if
    the RecurrentGemma prefill's count does not charge its ``n_rec``
    ``linear_scan`` launches by the kernel's formula.  The counts are made
    in child processes (``start_dryrun``), all stopped before it returns."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    where = Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    procs = start_dryrun(where)
    got = {"cells": {}, "steps": []}
    try:
        for i, proc in enumerate(procs):
            rc = proc.wait(timeout=600)
            if rc != 0:
                print((where / f"{i}.log").read_text()[-6000:], file=sys.stderr)
                raise AssertionError(f"dryrun: child process {i} exited {rc}")
            with open(where / f"{i}.counts.json") as f:
                part = json.load(f)
            got["cells"].update(part["cells"])
            got["steps"] += part["steps"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(where, ignore_errors=True)
    bad = []
    for name, cell in got["cells"].items():
        row = {"phase": "dryrun", "cell": name, "card": card, "arch": cell["arch"], "shape": cell["shape"],
               "mesh": cell["mesh"], "status": cell["status"], "constants": "H100 SXM data sheet (counted, not measured)"}
        if cell["status"] == "ok":
            r = cell["roofline"]
            row.update({k: r[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                                          "roofline_fraction", "collectives")},
                       chips=cell["chips"], memory=cell["memory"], kernels=cell["kernels"], count_s=cell["count_s"])
        else:
            row["error"] = cell.get("error")
            bad.append(name)
        emit(row)
    measured = {("lm", "recurrentgemma-2b"): (lm["prefill_ms"], lm["max_memory_allocated_bytes"])}
    measured.update({("lm_archs", r["arch"]): (r["prefill_ms"], r["max_memory_allocated_bytes"]) for r in archs})
    measured.update({("lm_archs_train", r["arch"]): (r["step"]["step_ms"], r["max_memory_allocated_bytes"])
                     for r in archs_train if "step" in r})
    for step in got["steps"]:
        ms, peak = measured[(step["phase"], step["arch"])]
        tc, tm = step["t_compute_s"] * 1e3, step["t_memory_s"] * 1e3
        emit({"phase": "dryrun_check", "card": card, "measured_in": step["phase"], **{k: step[k] for k in (
                  "arch", "kind", "layers", "batch", "tokens", "vis", "frames", "flops", "bytes", "kernels",
                  "argument_bytes", "temp_bytes", "predicted_peak_bytes", "extrapolated", "count_s")},
              "measured_ms": ms, "t_compute_ms": tc, "t_memory_ms": tm, "compute_share": tc / ms,
              "memory_share": tm / ms, "max_memory_allocated_bytes": peak,
              "predicted_peak_over_measured": step["predicted_peak_bytes"] / peak})
        if tc > COMPUTE_TERM_MAX_SHARE * ms:
            bad.append(f"{step['phase']}:{step['arch']} compute term {tc} ms > {COMPUTE_TERM_MAX_SHARE} x {ms} ms")
        if step["phase"] == "lm":
            scan = step["kernels"].get("linear_scan", {})
            per = 2.0 * step["batch"] * step["tokens"] * lm_width
            if scan.get("launches") != n_rec or scan.get("flops") != n_rec * per:
                bad.append(f"lm: the count charged linear_scan {scan}; want {n_rec} launches of {per} FLOPs")
    emit({"phase": "dryrun", "card": card, "cells": len(got["cells"]), "steps": len(got["steps"]),
          "children": len(procs), "seconds": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"dryrun: {bad}")


def main() -> int:
    if sys.argv[1:2] == ["--dryrun-counts"]:  # the dryrun phase's child process
        return dryrun_counts(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--extrap-cpu"]:  # the extrap parity's child process
        return extrap_cpu(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    # the lm_train phase's step frees and makes tensors of many sizes (per-leaf
    # optimizer temporaries as large as the embedding, (B, S, V) float32
    # gradients of the logits); without expandable segments the caching
    # allocator keeps much of the card reserved in blocks none of them fits,
    # and the second step runs out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import nn, obs
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
    from repro_torch.serve.graphs import padded_parts, row_bucket
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

    # the JAX kernels' width envelope (layer widths 1 to 128) at the same
    # shapes and a hidden width of 100 (no multiple of 8: the wrappers run the
    # banks zero-padded to 104) and of 128 (mp_sweep's 16-row fp32 z tile);
    # held against the plain versions and timed, but not the path's
    # representative case, and bounded by the unpadded work
    def env_bank(Hw, F, T=5):
        def w(*shape):
            return ((2.0 / (shape[-2] + shape[-1])) ** 0.5 * torch.randn(shape, generator=rng)).to(dev)
        return {"layers": [{"w": w(E, T, F, Hw), "b": (0.1 * torch.randn((E, T, Hw), generator=rng)).to(dev)},
                           {"w": w(E, T, Hw, Hw), "b": (0.1 * torch.randn((E, T, Hw), generator=rng)).to(dev)}]}

    for Hw in (100, 128):
        bank_w = env_bank(Hw, 2 * Hw)
        if Hw == 100:
            x_env = torch.randn((E, B, N, 2 * Hw), generator=rng).to(dev)
            rows.append({**bank_case(f"op_upd at hidden {Hw}, F={2 * Hw}, T=5 (widths zero-padded to 104)", bank_w,
                                     x_env, SLOT_RANGES, False), "envelope": True})
            del x_env
            h_env = torch.randn((E, B, N, Hw), generator=rng).to(dev)
            n_sel = E * int(((g.op_depth == 2) & (g.op_mask > 0)).sum())
            rows.append({**compare(
                "mp_update", f"scan step at hidden {Hw}, d=2, per-graph fields (widths zero-padded to 104)",
                lambda: mp_ops.mp_update(bank_w, h_env, g.a_flow, g.op_depth, g.op_mask, 2, SLOT_RANGES),
                lambda: mp_update_ref(bank_w, h_env, g.a_flow, g.op_depth, g.op_mask, 2, SLOT_RANGES),
                2.0 * n_sel * (N * Hw + 2 * Hw * Hw + Hw * Hw),
                4.0 * (2 * h_env.numel() + E * 5 * (3 * Hw * Hw + 2 * Hw)) + 4.0 * (
                    g.a_flow.numel() + g.op_depth.numel() + g.op_mask.numel())), "envelope": True})
            del h_env
        h_env = torch.randn((E, B, len(band.rows), Hw), generator=rng).to(dev)
        env_flops = sum(2.0 * E * int(((depth_b[:, s:e] == d) & (mask_b[:, s:e] > 0)).sum()) * (p * Hw + 3 * Hw * Hw)
                        for d, (s, e), _, p in sweep_levels)
        env_bytes = (4.0 * (2 * h_env.numel() + E * 5 * (3 * Hw * Hw + 2 * Hw))
                     + 4.0 * (a_b.numel() + depth_b.numel() + mask_b.numel()))
        rows.append({**compare(
            "mp_sweep", f"estimate_many at hidden {Hw}: {B} graphs, {len(band.rows)} trimmed rows, "
            f"{len(sweep_levels)} levels" + (" (widths zero-padded to 104)" if Hw % 8 else " (16-row fp32 z tile)"),
            lambda: sweep_ops.mp_sweep(bank_w, h_env, a_b, depth_b, mask_b, sweep_levels),
            lambda: mp_sweep_ref(bank_w, h_env, a_b, depth_b, mask_b, sweep_levels),
            env_flops, env_bytes), "envelope": True})
        del h_env, bank_w

    # gather_sum / segment_sum at score_many's shapes: the 16-structure drain's
    # rows as score_many runs them on the card, one chunk padded to its row
    # bucket (pad rows skeleton 0, placed nowhere), on the trimmed layout,
    # with the engine's own index tables
    skels16 = batch_graphs([build_graph_skeleton(q, c) for q, c, _ in drain])
    band16 = exact_banding(skels16)
    keep16 = torch.tensor(band16.rows if band16.rows is not None else range(N), device=dev)
    sk = graphs_to_device(skels16, dev)
    real16 = np.concatenate([np.full(len(a), i, dtype=np.int64) for i, (_, _, a) in enumerate(drain)])
    ids16, ap16 = (torch.as_tensor(np.concatenate(p), device=dev) for p in padded_parts(
        real16, np.concatenate([build_a_place_batch(q, c, a) for q, c, a in drain]), row_bucket(len(real16))))
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
    rows.append(gather_case(f"stage 2, P=1: {R16} rows ({len(real16)} real) of {len(drain)} structures", h_hw16, host16[..., None], placed16))
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
    counters = {"banked_mlp": "banked_mlp_slotted.launches", "mp_update": "mp_update.launches",
                "mp_sweep": "mp_sweep.launches", "gather_sum": "gather_sum.launches",
                "segment_sum": "segment_sum.launches", "linear_scan": "linear_scan.launches"}
    path_launches = {}  # path -> launches per kernel, counted over that path alone

    def launches():
        now = obs.counters()
        return {n: now.get(key, 0) for n, key in counters.items()}

    def counted(path, fn, need, never=()):
        """Run ``fn``; fail unless each kernel of ``need`` launched during it
        and none of ``never`` did."""
        before = launches()
        out = fn()
        torch.cuda.synchronize()
        got = {n: c - before[n] for n, c in launches().items()}
        for n, c in got.items():
            path_launches.setdefault(path, dict.fromkeys(counters, 0))[n] += c
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
        host = build_graph_skeleton(q, c)
        skel_d, n_hw = graphs_to_device(host, device), int(host.hw_mask.sum())
        ap = torch.as_tensor(build_a_place_batch(q, c, a), device=device)
        with torch.no_grad():
            return {m: gnn.apply_gnn_placed_stacked(nn.to_device(models[m][0], device), skel_d, ap,
                                                    query_static(q), models[m][1].gnn, n_hw).cpu().numpy()
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

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
    def step_split(cfg, p0, batch, reps=SIZES["timing_reps"]):
        g1, y1, band1 = batch
        p, state = p0, opt.init(p0)
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

    split_k, split_p = step_split(tcfg, params0, (g1, y1, band1)), step_split(pcfg, params0, (g1, y1, band1))
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

    # -- 5. distributed: the DP step, the pipeline and re-sharding on one rank -------
    distributed_phase(params0, (g1, y1, band1), tcfg, opt, tcfg_train, counted, cuda_ms, timed, card)
    del served, results, params0, g1, y1, val_g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 6. baselines: the traditional-MP GNN, the flat vector, the other training
    # stages, in the train phase's artifact root ------------------------------------
    row, extrap_card = baselines_phase(corpus, host_batch, queries[2], counted, device_split, timed, check_answers,
                                       bank_case, step_split, card)
    rows.append(row)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 7. service and 8. control: the trained bundle behind PlacementService
    # and the fleet controller ------------------------------------------------
    svc_est, svc_cpu = service_phase(bundle, lambda: artifacts.load_bundle("main"), counted, device_split, card)
    control_phase(svc_est, svc_cpu, counted, card)
    shutil.rmtree(train_root, ignore_errors=True)
    del bundle, svc_est, svc_cpu
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 9. lm: RecurrentGemma-2B serving through make_serve_step -----------------
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
    del cache_k, cache_p, prefilled, empty_cache, lg, lg_p, nxt, nxt_p, tokens
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
    del r_cpu, r_dev, caches, pairs

    # -- 10. lm_train: RecurrentGemma-2B training through make_train_step ----------
    weights = {"params": lm_params}
    del lm_params
    lm_train = lm_train_phase(lm_cfg, weights, counted, cuda_ms, timed, card, costream)
    backward["linear_scan"] = {"ms": lm_train["scan_backward"]["ms"],
                               "plain_ms": lm_train["scan_backward"]["plain_ms"],
                               "bound_ms": lm_train["scan_backward"]["bound_ms"],
                               "launches_per_step": lm_train["model"]["rglru_layers"]}

    # -- 11. lm_archs: the other decoder-only architectures through make_serve_step --
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    archs = lm_archs_phase(counted, timed, device_split, aten_ops, card, costream + ("linear_scan",))

    # -- 12. lm_archs_train: the nine architectures through make_train_step ----------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    archs_train = lm_archs_train_phase(counted, timed, card, costream + ("linear_scan",))

    # -- 13. examples: the port's five examples through their entry points -----------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    examples_phase(counted, card)

    # -- 14. dryrun: the hillclimb cells on the 16 x 16 mesh, and each measured LM step's count on one GPU;
    # beside it, the extrap runs trained again on the CPU plain path, and held against the card's --
    extrap_procs = start_extrap_cpu(extrap_card[0])
    try:
        dryrun_phase(lm, archs, archs_train, card, n_rec, width)
        extrap_parity_phase(extrap_procs, *extrap_card, card)
    finally:
        for proc in extrap_procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(extrap_card[0], ignore_errors=True)

    # -- 15. kernel summary (the representative case: the most work on the path) ------
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
        rep = max((r for r in mine if not r.get("envelope")), key=lambda r: r["flops"])
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(path[name] for path in path_launches.values()),
                        "launches_by_path": {k: v[name] for k, v in path_launches.items() if v[name]},
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"], "case": rep["case"],
                        "shape": rep["shape"], **{k: rep[k] for k in ("per_level_ms", "per_level_max_abs_err") if k in rep},
                        # the backward at the training shape: the plain version's VJP, or for
                        # linear_scan the reversed scan on the kernel (with its plain VJP's ms and its bound)
                        "backward_ms": backward[name]["ms"] if name in backward else None,
                        **{f"backward_{k}": backward[name][k] for k in ("plain_ms", "bound_ms") if k in backward.get(name, {})},
                        "backward_launches_per_train_step": backward[name]["launches_per_step"] if name in backward else 0})
    emit({"kernels": summary})

    # -- 16. the card, 17. status ---------------------------------------------------
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
