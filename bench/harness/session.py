"""One run of one cell: set-up, warm-up, the measured window, the traced stretch, the check.

``run`` makes the weights and the traffic from the seed, builds the program's kernels and its
estimator, warms every call of the schedule's cycle once (set-up ends there), then keeps
``in_flight`` calls queued for ``seconds`` on the host clock.  With ``trace`` it then drains the
queue and runs the same loop under ``torch.profiler`` for a stretch.  Then it reads the memory
peak, frees the program, works every compared call's items out again with the plain reference,
and reads the cell's metrics through their readers (``bench/metrics/<name>.py``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from bench.harness import facts as F
from bench.harness import profile as P
from bench.harness import spec, traffic as T, weights as Wt
from bench.harness.check import Comparison
from bench.harness.program import Program
from bench.reference import featurize as R
from bench.reference import gnn as ref_gnn

TRACE_SECONDS = 2.0  # the traced stretch, after the window
KERNELS = ("banked_mlp", "mp_update", "mp_sweep", "seg_gather")  # the COSTREAM kernels' libraries


@dataclass
class Call:
    index: int
    t_start: float
    t_dispatched: float
    t_done: float = math.nan
    items: int = 0


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    entry: str
    model: dict
    setup_s: float
    window_s: float
    calls: List[Call]
    trace: Optional[object] = None  # profile.Trace of the traced stretch
    works: Dict[int, F.CallWork] = field(default_factory=dict)  # cycle position -> the call's work
    cycle: int = 1

    def work(self, i: int) -> F.CallWork:
        return self.works[i % self.cycle]


def _reference_items(traffic: T.Traffic) -> R.Graphs:
    """Every pool item featurized by the reference, in global id order."""
    if traffic.entry == "score_many":
        return R.concat([R.placed(q, c, pool) for q, c, pool in traffic.structures])
    return R.traces(traffic.traces)


def _works(traffic: T.Traffic, items: F.Facts, model: dict) -> Dict[int, F.CallWork]:
    E = int(model["members"]) * len(model["metrics"])
    H = int(model["hidden"])
    out = {}
    for i in range(traffic.cycle()):
        rows = items.take(traffic.item_ids(i))
        if traffic.entry == "score_many":
            firsts = [int(traffic.offsets[s]) for s, _ in traffic.requests(i)]
            stage0 = items.take(np.asarray(firsts))
        else:
            stage0 = rows
        out[i] = F.CallWork(traffic.entry, rows, stage0, E, H)
    return out


def _loop(program, start: int, until: float, in_flight: int, keep, record_function=None, count=None):
    """Calls ``start, start + 1, ...`` with ``in_flight`` queued, dispatched while the host clock
    is below ``until`` (and, with ``count``, ``count`` of them), then drained.  Returns the calls
    and the kept calls' answers."""
    span = record_function or (lambda name: contextlib.nullcontext())
    calls: List[Call] = []
    kept: Dict[int, Dict[str, np.ndarray]] = {}
    queue = deque()
    i = start

    def finish():
        call, handle = queue.popleft()
        with span("bench.finalize"):
            answers = program.finish(handle)
        call.t_done = time.perf_counter()
        call.items = len(next(iter(answers.values())))
        if keep(call.index):
            kept[call.index] = answers

    while True:
        t = time.perf_counter()
        if t >= until or (count is not None and i >= start + count):
            break
        with span("bench.dispatch"):
            handle = program.dispatch(i)
        call = Call(i, t, time.perf_counter())
        calls.append(call)
        queue.append((call, handle))
        if len(queue) >= in_flight:
            finish()
        i += 1
    while queue:
        finish()
    return calls, kept


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        root=spec.ROOT, overrides: Optional[dict] = None, control: bool = False) -> dict:
    """One run; returns the result line (without ``device``'s card fields) and the check.

    ``control`` also holds the control (the reference in TF32, in the program's place) against the
    reference on the same compared items, under ``"control"``: the calibration of the limits
    (``bench/calibrate.py``), never a benchmark run."""
    os.environ["REPRO_DISPATCH_PROFILE"] = "default"  # no host profile may change what is measured
    import torch

    cell = spec.cell(cell_name, root)
    mix = dict(cell.traffic, **(overrides or {}))
    model = cell.config["model"]
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all(KERNELS)
        torch.cuda.reset_peak_memory_stats()
    weights = Wt.make(seed, model["metrics"], model["members"], model["hidden"], dev)
    traffic = T.build(cell.config, mix, seed)
    program = Program(traffic, weights, model, dev)
    del weights
    # every call of the schedule's cycle once, queued as the window queues them, then drained
    _loop(program, 0, math.inf, traffic.in_flight, lambda i: False, count=traffic.cycle())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the pools are millions of long-lived Python objects; a full collection over them inside the
    # window would stall the host for tenths of a second, so they are frozen out of its scans
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    decide = T.check_calls(seed, traffic.check_share)
    chosen: Dict[int, bool] = {}

    def keep(i):
        if i not in chosen:
            chosen[i] = i == 0 or next(decide)
        return chosen[i]

    t0 = time.perf_counter()
    calls, kept = _loop(program, 0, t0 + seconds, traffic.in_flight, keep)
    window_s = time.perf_counter() - t0
    for c in calls:
        c.t_start -= t0
        c.t_dispatched -= t0
        c.t_done -= t0

    stretch = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        first = len(calls)
        with profile(activities=activities) as prof:
            with record_function(P.STRETCH):
                s_calls, s_kept = _loop(program, first, time.perf_counter() + min(TRACE_SECONDS, seconds),
                                        traffic.in_flight, keep, record_function)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
        kept.update(s_kept)
        stretch = P.reduce(prof, [c.index for c in s_calls])

    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    program.close()
    del program
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the plain reference: every pool item featurized again, the kept calls' items answered
    items = _reference_items(traffic)
    ref_weights = ref_gnn.stack(Wt.make(seed, model["metrics"], model["members"], model["hidden"], dev),
                                model["metrics"])
    needed = np.unique(np.concatenate([traffic.item_ids(i) for i in kept])) if kept else np.zeros(0, np.int64)
    raw = np.zeros((len(model["metrics"]) * model["members"], traffic.n_items), np.float32)
    if needed.size:
        raw[:, needed] = ref_gnn.raw_outputs(ref_weights, R.take(items, needed), dev)
    comparison = Comparison(model["metrics"], model["members"])
    for i in sorted(kept):
        comparison.add(kept[i], raw[:, traffic.item_ids(i)])
    if control:
        low = np.zeros_like(raw)
        if needed.size:
            low[:, needed] = ref_gnn.raw_outputs(ref_weights, R.take(items, needed), dev, precision="tf32")
        held = Comparison(model["metrics"], model["members"])
        M = model["members"]
        for i in sorted(kept):
            ids = traffic.item_ids(i)
            held.add({m: ref_gnn.vote(low[k * M : (k + 1) * M, ids], m) for k, m in enumerate(model["metrics"])},
                     raw[:, ids])

    record = Run(cell_name, traffic.entry, model, setup_s, window_s, calls, stretch,
                 _works(traffic, F.of_graphs(items), model), traffic.cycle())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": comparison.correct(),
        "attempted": len(calls) + (len(stretch.calls) if stretch else 0),
        "failed": 0,
        "metrics": metrics,
        "device": {"count": cell.chips, "memory_peak_bytes": peak},
        "check": comparison.numbers(),
    }
    if control:
        out["control"] = held.numbers()
    if stretch is not None:
        out["device"].update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        out["breakdown"] = P.breakdown(stretch)
    return out
