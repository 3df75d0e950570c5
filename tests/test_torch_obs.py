"""The port's tracer (``repro_torch.obs``) on the CPU.

Off, the facade's entries leave no record and open no profiler range, and a span costs under a
microsecond.  Under ``torch.profiler`` (CPU activity), each entry gives its span tree, with one
call id across its dispatch and its deferred finalize; self times are non-negative and sum to the
roots' durations; each record matches its profiler event within 50 us; the forward's stage-3 row
counts equal a count by hand; a second stretch leaves only its own records; the buffer is bounded;
counters lose no update across threads; the caches count their hits and misses;
``PlacementService``'s drains nest the estimator's spans.  A readback queued at dispatch (the GPU
path, with a stand-in event) counts ``d2h.ready`` or ``d2h.blocked`` and marks its ``d2h.wait``;
the CPU path counts neither.
"""

import os
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import gnn
from repro_torch.core.graph import MAX_OPS, batch_graphs, build_graph
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.placement.enumerate import sample_assignment_matrix
from repro_torch.serve.estimator import CostEstimator, _host, _Readback
from repro_torch.serve.service import PlacementService

ENTRIES = ("estimate", "estimate_many", "score_many", "score")


def _estimator():
    cfg = gnn.GNNConfig(hidden=16, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {
        m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg, n_ensemble=2)),
            CostModelConfig(metric=m, gnn=cfg, n_ensemble=2))
        for m in ("latency_p", "success")
    }
    return CostEstimator(models, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """A warm estimator (every cache filled) and one call of each entry."""
    est = _estimator()
    work = WorkloadGenerator(seed=1)
    traces = work.corpus(6)
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    reqs = []
    for i, kind in enumerate(("linear", "two_way")):
        q, c = work.query(kind=kind, name=f"r{i}"), work.cluster(4)
        reqs.append((q, c, sample_assignment_matrix(q, c, 5, np.random.default_rng(i))))
    calls = {
        "estimate": lambda: est.estimate(g, deferred=True).result(),
        "estimate_many": lambda: est.estimate_many([g, traces[:2]], deferred=True).result(),
        "score_many": lambda: est.score_many(reqs, deferred=True).result(),
        "score": lambda: est.score(*reqs[1], deferred=True).result(),
    }
    for call in calls.values():
        call()
    with profile(activities=[ProfilerActivity.CPU]):  # the profiler's and the ranges' first use
        for call in calls.values():
            call()
    return est, traces, g, reqs, calls


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, obs.records()


def _tree(records, root):
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)

    def walk(r):
        return (r.name, tuple(walk(k) for k in sorted(kids.get(r.id, []), key=lambda k: k.start_ns)))

    return walk(root)


def _leaf(name):
    return (name, ())


STAGE, FORWARD, WAIT, VOTE = _leaf("h2d.stage"), "gnn.forward", _leaf("d2h.wait"), _leaf("host.vote")
TREES = {
    "estimate": [
        ("estimator.estimate", (STAGE, _leaf(FORWARD))),
        ("estimator.finalize", (WAIT, VOTE, VOTE)),
    ],
    "estimate_many": [
        ("estimator.estimate_many", (("host.merge", (_leaf("host.featurize"),)), _leaf("host.banding"), STAGE,
                                     (FORWARD, (STAGE,)))),
        ("estimator.finalize", (WAIT, VOTE, VOTE, VOTE)),
    ],
    "score_many": [
        ("estimator.score_many", (_leaf("host.keys"), _leaf("host.group"), _leaf("host.a_place"), STAGE,
                                  (FORWARD, (STAGE,)))),
        ("estimator.finalize", (WAIT, VOTE, VOTE, VOTE, VOTE)),
    ],
    "score": [
        ("estimator.score", (_leaf("host.a_place"), STAGE, (FORWARD, (STAGE,)))),
        ("estimator.finalize", (WAIT, VOTE, VOTE)),
    ],
}


def test_spans_off_leave_no_record_and_open_no_range(setup, monkeypatch):
    est, traces, g, reqs, calls = setup
    opened = []
    monkeypatch.setattr(obs, "_range", lambda name: opened.append(name))
    before = obs.records()
    for entry in ("estimate", "estimate_many", "score_many"):
        calls[entry]()
    assert opened == [] and obs.records() == before


def test_a_span_off_costs_under_a_microsecond():
    n, best = 10_000, float("inf")
    for _ in range(25):
        t = time.perf_counter()
        for _ in range(n):
            with obs.span("x", n=3):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 1e-6, f"{best * 1e6:.3f} us a span"


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_entry_gives_its_span_tree_under_one_call_id(setup, entry):
    _, records = _profiled(setup[4][entry])
    roots = sorted((r for r in records if r.parent is None), key=lambda r: r.start_ns)
    assert [_tree(records, r) for r in roots] == TREES[entry]
    assert len({r.call for r in records}) == 1  # the dispatch and its deferred finalize join
    covered = {}
    for r in records:
        if r.parent is not None:
            covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
    own = [r.end_ns - r.start_ns - covered.get(r.id, 0) for r in records]
    assert min(own) >= 0
    assert sum(own) == sum(r.end_ns - r.start_ns for r in roots)


def test_each_record_matches_its_profiler_event_within_50_us(setup):
    prof, records = _profiled(lambda: [call() for call in setup[4].values()])
    names = {r.name for r in records}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e)
    for name in names:
        ours = sorted((r for r in records if r.name == name), key=lambda r: r.start_ns)
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(ours) == len(theirs), name
        for r, e in zip(ours, theirs):
            assert abs(r.start_ns - e.start_ns()) < 50_000, (name, r.start_ns - e.start_ns())
            assert abs(r.end_ns - e.end_ns()) < 50_000, (name, r.end_ns - e.end_ns())


def test_stage3_rows_equal_a_count_by_hand(setup):
    est, traces, _, _, _ = setup
    pair = traces[:2]
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in pair])
    # an operator is at depth 1 or more exactly when some edge enters it
    real = sum(len({v for _, v in t.query.edges}) for t in pair)
    depth = est.config("latency_p").gnn.max_depth
    _, records = _profiled(lambda: (est.estimate(g), est.estimate_many([g])))
    scan, banded = [r.attrs for r in records if r.name == "gnn.forward"]
    assert scan == {"rows3": depth * 2 * MAX_OPS, "real3": real, "graph": "eager"}
    assert banded["real3"] == real and real <= banded["rows3"] < scan["rows3"]


def test_a_second_stretch_leaves_only_its_own_records(setup):
    calls = setup[4]
    with profile(activities=[ProfilerActivity.CPU]):
        calls["estimate"]()
    first = {r.id for r in obs.records()}
    with profile(activities=[ProfilerActivity.CPU]):
        calls["score"]()
    second = obs.records()
    assert first and second and not first & {r.id for r in second}
    assert {r.name for r in second if r.parent is None} == {"estimator.score", "estimator.finalize"}
    with profile(activities=[ProfilerActivity.CPU]):  # a stretch that opens no span
        pass
    assert obs.records() == ()


def test_records_stay_bounded(monkeypatch):
    assert obs._records.maxlen == obs.MAX_RECORDS
    monkeypatch.setattr(obs, "_records", deque(maxlen=16))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(40):
            with obs.span(f"s{i}"):
                pass
    assert [r.name for r in obs.records()] == [f"s{i}" for i in range(24, 40)]


def test_counters_lose_no_update_across_threads():
    before = obs.counters().get("stress.count", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(5_000):
                obs.count("stress.count")

        threads = [threading.Thread(target=add) for _ in range(4 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert obs.counters()["stress.count"] - before == 5_000 * len(threads)


def test_the_caches_count_hits_and_misses(setup):
    est = _estimator()
    _, _, g, reqs, _ = setup
    before = obs.counters()
    est.score_many(reqs)
    est.score_many(reqs[::-1])  # the same mix in another order: a group hit
    est.estimate_many([g])
    moved = {k: v - before.get(k, 0) for k, v in obs.counters().items() if k.startswith("cache.")}
    assert moved["cache.skeleton.miss"] == 2 and moved.get("cache.skeleton.hit", 0) == 0
    assert (moved["cache.group.miss"], moved["cache.group.hit"]) == (1, 1)
    assert moved["cache.banding.hit"] + moved["cache.banding.miss"] == 2  # the group's and the batch's


def test_service_drains_nest_the_estimators_spans(setup):
    est, _, _, reqs, _ = setup
    svc = PlacementService(est, auto_start=False, double_buffer=True)
    futures = [svc.submit_score(q, c, a) for q, c, a in reqs]
    with profile(activities=[ProfilerActivity.CPU]):
        svc.start()
        for f in futures:
            f.result(timeout=60)
        svc.close()
    records = obs.records()
    by_id = {r.id: r for r in records}
    drains = [r for r in records if r.name == "service.drain"]
    assert drains[0].attrs == {"n": len(reqs), "ids": list(range(len(reqs)))}
    launch = next(r for r in records if r.name == "service.launch")
    finalize = next(r for r in records if r.name == "service.finalize")
    assert by_id[launch.parent].name == "service.drain" and by_id[finalize.parent].name == "service.drain"
    assert finalize.call == launch.call == drains[0].call
    assert finalize.parent != launch.parent  # double-buffered: finalized by the next drain
    for r in records:
        if r.name.startswith("estimator."):
            assert r.call == launch.call
            parent = by_id[r.parent]
            assert parent.name == ("service.finalize" if r.name == "estimator.finalize" else "service.launch")
    assert {by_id[r.parent].name for r in records if r.name == "service.pop"} == {"service.drain"}


class _Event:
    """A stand-in for a ``torch.cuda.Event`` recorded after a readback's copy."""

    def __init__(self, ready: bool):
        self.ready, self.waited = ready, False

    def query(self) -> bool:
        return self.ready

    def synchronize(self) -> None:
        self.waited = True


def _d2h_moved(before) -> dict:
    return {k: obs.counters().get(k, 0) - before.get(k, 0) for k in ("d2h.ready", "d2h.blocked")}


@pytest.mark.parametrize("ready", [True, False])
def test_a_queued_readback_counts_whether_it_had_landed(ready):
    raw, done = torch.arange(6.0).reshape(2, 3), _Event(ready)
    before = obs.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _host(_Readback(raw, done))
    assert done.waited and _d2h_moved(before) == {"d2h.ready": int(ready), "d2h.blocked": int(not ready)}
    np.testing.assert_array_equal(got, raw.numpy())
    (wait,) = [r for r in obs.records() if r.name == "d2h.wait"]
    assert wait.attrs == {"bytes": 24, "ready": int(ready)}


def test_the_cpu_readback_queues_nothing(setup):
    before = obs.counters()
    _, records = _profiled(lambda: [call() for call in setup[4].values()])
    assert _d2h_moved(before) == {"d2h.ready": 0, "d2h.blocked": 0}
    waits = [r.attrs for r in records if r.name == "d2h.wait"]
    assert waits and all(set(a) == {"bytes"} for a in waits)


def test_launches_in_a_capture_tally_stay_out_of_the_counters():
    """A launch inside this thread's ``capture_tally`` goes to the tally and not to the
    ``<kernel>.launches`` counter; a launch on another thread meanwhile, and one after the tally
    closes, are counted."""
    before = obs.counters().get("tally_probe.launches", 0)
    with obs.capture_tally() as tally:
        obs.launch("tally_probe")
        other = threading.Thread(target=obs.launch, args=("tally_probe",))
        other.start()
        other.join(timeout=60)
        obs.launch("tally_probe")
    obs.launch("tally_probe")
    assert tally == {"tally_probe.launches": 2}
    assert obs.counters()["tally_probe.launches"] - before == 2
