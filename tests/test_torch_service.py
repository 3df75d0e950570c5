"""The port's serving stack above ``CostEstimator`` against the JAX package.

Dispatch policy and host profiles, the estimator's hook seam and the chaos
injectors, the serving lifecycle (circuit breaker, fallback scores, shadow
verdicts), ``PlacementService`` and the open-loop load tools: each is driven
with the same inputs in both packages, over one JAX-written bundle where a
model answers.  Service answers agree within ``rtol=1e-4, atol=1e-6`` (the
bound of ``tests/test_torch_serve.py``) with equal counters; arrival
schedules, breaker sequences and fallback scores are equal exactly.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core as jcore
import repro.serve as jserve
import repro.serve.chaos as jchaos
import repro.serve.load as jload
import repro.serve.policy as jpolicy
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.placement import sample_assignment_matrix as jax_sample
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph import batch_graphs, build_graph
from repro_torch.core.model import CostModelConfig, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.placement.enumerate import heuristic_placement, sample_assignment_matrix
from repro_torch.serve import chaos, load, policy
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator, NonFiniteEstimate
from repro_torch.serve.lifecycle import BundleSwapper, CircuitBreaker, fallback_scores
from repro_torch.serve.service import PlacementService, ServiceOverloadError

METRICS = ("latency_p", "throughput", "success")

#: fast lifecycle thresholds (the JAX package's tests/test_lifecycle.py values)
_LIFE = dict(
    shadow_fraction=1.0,
    shadow_min_requests=3,
    health_window_requests=4,
    health_error_rate_max=0.25,
    breaker_window=8,
    breaker_failure_rate=0.5,
    breaker_min_samples=2,
    breaker_cooldown_s=0.05,
    retry_max_attempts=2,
    retry_backoff_s=0.001,
)


def _jax_models(key_base=0, hidden=16):
    models = {}
    for i, m in enumerate(METRICS):
        cfg = jcore.CostModelConfig(metric=m, n_ensemble=2, gnn=jcore.GNNConfig(hidden=hidden, use_pallas=True))
        models[m] = (jcore.init_cost_model(jax.random.PRNGKey(key_base + i), cfg), cfg)
    return models


def _write(models, directory):
    jserve.CostModelBundle(models, meta={"corpus_fingerprint": "abc"}).save(str(directory))
    return str(directory)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Two JAX-written bundles (different weights) as (JAX models, directory)."""
    root = tmp_path_factory.mktemp("service")
    a, b = _jax_models(0), _jax_models(50)
    return (a, _write(a, root / "a")), (b, _write(b, root / "b"))


@pytest.fixture(scope="module")
def pair(bundles):
    """(JAX estimator, port estimator on the CPU) over bundle A."""
    (models, directory), _ = bundles
    return jserve.CostEstimator(models), CostEstimator.from_bundle(CostModelBundle.load(directory), device="cpu")


def _port(directory, **kw):
    return CostEstimator.from_bundle(CostModelBundle.load(directory), device="cpu", **kw)


def _structures(n=3, seed=171):
    """The same (query, cluster) pairs in both packages."""
    kinds = ("linear", "two_way", "three_way")
    gen, jgen = WorkloadGenerator(seed=seed), JaxGenerator(seed=seed)
    ours = [(gen.query(kind=kinds[i % 3], name=f"svc{i}"), gen.cluster(3 + i)) for i in range(n)]
    theirs = [(jgen.query(kind=kinds[i % 3], name=f"svc{i}"), jgen.cluster(3 + i)) for i in range(n)]
    return ours, theirs


def _cands(q, c, n, seed):
    a = sample_assignment_matrix(q, c, n, np.random.default_rng(seed))
    return a[np.arange(n) % len(a)]


def _traces(n, seed):
    return WorkloadGenerator(seed=seed).corpus(n), JaxGenerator(seed=seed).corpus(n)


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for m in want:
        np.testing.assert_allclose(np.asarray(got[m]), np.asarray(want[m]), rtol=1e-4, atol=1e-6, err_msg=f"{what} {m}")


def _counts(stats):
    return {k: getattr(stats, k) for k in ("n_requests", "n_batches", "n_forwards", "n_coalesced", "n_cross_query",
                                           "n_drained", "n_degraded", "n_failed", "n_retries")}


# -- policy -----------------------------------------------------------------------

_INVALID = [
    ({"max_batch": 0}, "max_batch"),
    ({"trace_cache_size": -1}, "trace_cache_size"),
    ({"score_chunk": None}, "score_chunk"),
    ({"double_buffer": "yes"}, "double_buffer"),
    ({"shadow_fraction": 1.5}, "shadow_fraction"),
    ({"retry_backoff_s": float("nan")}, "retry_backoff_s"),
    ({"breaker_min_samples": 20, "breaker_window": 16}, "breaker_min_samples"),
    ({"health_error_rate_max": 0.0}, "health_error_rate_max"),
]


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("fields,match", _INVALID, ids=[m for _, m in _INVALID])
def test_both_packages_reject_the_same_policy_fields(package, fields, match):
    mod = jpolicy if package == "jax" else policy
    with pytest.raises(ValueError, match=match):
        mod.DispatchPolicy(**fields).validate()
    with pytest.raises(ValueError, match=match):
        mod.DispatchPolicy.from_dict({**mod.DispatchPolicy().to_dict(), **fields})
    with pytest.raises(ValueError, match="unknown"):
        mod.DispatchPolicy.from_dict({"not_a_knob": 1})


def test_policy_fields_and_defaults_equal_jax():
    assert policy.DispatchPolicy().to_dict() == jpolicy.DispatchPolicy().to_dict()
    assert policy.PROFILE_SCHEMA_VERSION == jpolicy.PROFILE_SCHEMA_VERSION
    assert policy.RetryPolicy().sleep_s(2, 0.3) == jpolicy.RetryPolicy().sleep_s(2, 0.3)
    p = policy.DispatchPolicy(cross_query_row_limit=None, score_chunk=0, double_buffer=True)
    assert policy.DispatchPolicy.from_dict(json.loads(json.dumps(p.to_dict()))) == p
    auto = policy.DispatchPolicy()
    assert auto.resolved_double_buffer("cuda") and not auto.resolved_double_buffer("cpu")
    assert not policy.DispatchPolicy(double_buffer=False).resolved_double_buffer("cuda")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_profile_written_by_one_package_loads_in_the_other(writer, tmp_path):
    src, dst = (jpolicy, policy) if writer == "jax" else (policy, jpolicy)
    path = tmp_path / "prof.json"
    tuned = {"cross_query_row_limit": 4, "score_chunk": 64, "breaker_window": 12}
    src.save_profile(path, src.DispatchPolicy(**tuned), measurements={"note": writer})
    assert src.load_profile(path)["policy_obj"] == src.DispatchPolicy(**tuned)  # its own host matches
    payload = dst.load_profile(path, require_host_match=False)
    assert payload is not None and payload["policy_obj"] == dst.DispatchPolicy(**tuned)
    assert payload["measurements"] == {"note": writer}
    with pytest.warns(dst.DispatchProfileWarning, match="another machine"):
        assert dst.load_profile(path, require_host_match=True) is None


def test_resolve_policy_honours_the_env_override(tmp_path, monkeypatch):
    path = tmp_path / "pinned.json"
    jpolicy.save_profile(path, jpolicy.DispatchPolicy(max_batch=48))  # a JAX profile, pinned explicitly
    monkeypatch.setenv(policy.PROFILE_ENV, str(path))
    assert policy.resolve_policy() == policy.DispatchPolicy(max_batch=48)
    assert _port_from_models().policy.max_batch == 48  # the estimator resolves it when given none
    for pin in ("default", "none", "0"):
        monkeypatch.setenv(policy.PROFILE_ENV, pin)
        assert policy.resolve_policy() == policy.DispatchPolicy()
    monkeypatch.setenv(policy.PROFILE_ENV, str(tmp_path / "missing.json"))
    with pytest.raises(ValueError, match="valid dispatch profile"):
        policy.resolve_policy()
    with policy.use_policy(policy.DispatchPolicy(search_k=5)):
        assert policy.active_policy().search_k == 5


def _port_from_models():
    cfg = CostModelConfig(metric="latency_p", n_ensemble=1, gnn=GNNConfig(hidden=8))
    return CostEstimator({"latency_p": (init_cost_model(torch.Generator().manual_seed(0), cfg), cfg)}, device="cpu")


def test_autotune_quick_on_the_cpu_writes_a_valid_profile(tmp_path, capsys):
    out = tmp_path / "tuned.json"
    res = policy.autotune(quick=True, budget_s=60, out=out, device="cpu")
    assert not res.reused_cached and res.path == out
    assert res.measurements["kernel_tiles"]["skipped"].startswith("CUDA kernels size their own grids")
    assert "cross_query_band" in res.measurements and "chunk_timings_s" in res.measurements
    assert res.policy.sweep_tile_rows == 128 and res.policy.seg_gather_tile == 128
    assert policy.load_profile(out)["policy_obj"] == res.policy
    assert jpolicy.load_profile(out, require_host_match=False)["policy_obj"].to_dict() == res.policy.to_dict()
    assert policy.autotune(quick=True, out=out, device="cpu").reused_cached
    # the CLI: a budget-0 run, --validate, --expect-cached
    cli = tmp_path / "cli.json"
    assert policy.main(["--quick", "--budget-s", "0", "--out", str(cli), "--device", "cpu"]) == 0
    assert policy.main(["--validate", str(cli)]) == 0
    assert policy.main(["--quick", "--budget-s", "0", "--out", str(cli), "--device", "cpu", "--expect-cached"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.warns(policy.DispatchProfileWarning):
        assert policy.main(["--validate", str(bad)]) == 1
    capsys.readouterr()


@pytest.mark.parametrize(
    "row_limit,chunk,caches", [(1, 0, 1), (8, 2, 2), (None, 64, 4), (64, 256, 3)]
)
def test_any_valid_policy_changes_only_performance(bundles, row_limit, chunk, caches):
    """Float-identical ``score_many`` / ``score`` / ``estimate_many`` answers
    across the policy grid of the JAX package's tests/test_policy.py."""
    (_, directory), _ = bundles
    (structs, _), (traces, _) = _structures(3, seed=31), _traces(5, seed=3)
    requests = [(q, c, _cands(q, c, 5, 31 + i)) for i, (q, c) in enumerate(structs)]
    graphs = [traces[:2], traces[2:]]

    def run(pol):
        est = _port(directory, policy=pol)
        with policy.use_policy(pol):
            scores = est.score_many(requests)
            q0, c0, a0 = requests[0]
            scores.append(est.score(q0, c0, a0))
            return scores, est.estimate_many(graphs)

    base_scores, base_ests = run(policy.DispatchPolicy())
    pol = policy.DispatchPolicy(
        cross_query_row_limit=row_limit, score_chunk=chunk, max_batch=8, trace_cache_size=caches,
        banding_cache_size=caches, skeleton_cache_size=caches, merged_group_cache_size=caches,
    ).validate()
    got_scores, got_ests = run(pol)
    for want, have in zip(base_scores + base_ests, got_scores + got_ests):
        for m in want:
            np.testing.assert_array_equal(have[m], want[m], err_msg=f"{m} {pol}")


# -- the hook seam and the chaos injectors --------------------------------------------


def _chaos_calls(est, structs, traces, sample):
    """The four dispatch kinds, twice over: each call's outcome."""
    (q0, c0), (q1, c1) = structs[:2]
    a0, a1 = sample(q0, c0, 4, 5), sample(q1, c1, 4, 6)
    calls = [
        lambda: est.score(q0, c0, a0),
        lambda: est.estimate(traces),
        lambda: est.score_many([(q0, c0, a0), (q1, c1, a1)]),
        lambda: est.estimate_many([traces[:2], traces[2:]]),
    ] * 3
    out = []
    for call in calls:
        try:
            call()
            out.append("ok")
        except (NonFiniteEstimate, jserve.NonFiniteEstimate):
            out.append("nan")
        except (chaos.ChaosError, jchaos.ChaosError):
            out.append("raised")
    return out


def test_chaos_schedule_matches_jax(pair):
    """The same seeded injectors, installed in both estimators, fire at the
    same calls; an injected NaN raises the finiteness guard's error."""
    jest, est = pair
    (structs, jstructs), (traces, jtraces) = _structures(2), _traces(4, seed=5)

    def jsample(q, c, n, seed):
        a = jax_sample(q, c, n, np.random.default_rng(seed))
        return a[np.arange(n) % len(a)]

    runs = {}
    for name, mod, e, st, tr, sample in (("torch", chaos, est, structs, traces, _cands),
                                         ("jax", jchaos, jest, jstructs, jtraces, jsample)):
        hooks = [mod.RaiseFault(p=0.3, seed=11), mod.NaNFault(p=0.3, seed=12), mod.HangFault(hang_s=0.001, p=0.5, seed=13)]
        for h in hooks:
            e.add_hook(h)
        try:
            outcomes = _chaos_calls(e, st, tr, sample)
        finally:
            for h in hooks:
                e.remove_hook(h)
        runs[name] = (outcomes, [h.n_injected for h in hooks])
    assert runs["torch"] == runs["jax"]
    outcomes, injected = runs["torch"]
    assert "nan" in outcomes and "raised" in outcomes and all(injected)


def test_hooks_see_the_same_dispatch_kinds_and_counts(pair):
    jest, est = pair
    (structs, jstructs), (traces, jtraces) = _structures(2), _traces(4, seed=6)

    class Rec:
        def __init__(self):
            self.seen = []

        def before(self, kind, n):
            self.seen.append(("before", kind, n))

        def after(self, kind, out):
            self.seen.append(("after", kind, len(out) if isinstance(out, list) else sorted(out)))

    seen = []
    for e, (s0, s1), tr, sample in ((est, structs, traces, sample_assignment_matrix),
                                    (jest, jstructs, jtraces, jax_sample)):
        rec = Rec()
        e.add_hook(rec)
        a0 = sample(*s0, 3, np.random.default_rng(1))
        a1 = sample(*s1, 2, np.random.default_rng(2))
        pending = e.score(*s0, a0, deferred=True)
        assert [k for k, *_ in rec.seen] == ["before"], "after-hooks run at finalize"
        pending.result()
        e.score_many([(*s0, a0), (*s1, a1)])
        e.estimate_many([tr[:1], tr[1:]])
        e.estimate(tr)
        e.remove_hook(rec)
        seen.append(rec.seen)
    assert seen[0] == seen[1]


# -- lifecycle --------------------------------------------------------------------


def test_breaker_sequence_matches_jax():
    """One outcome stream on a fake clock: the same states, allows and opens."""
    rng = np.random.default_rng(3)
    stream = [("tick", float(t)) if t else ("fail" if rng.random() < 0.6 else "ok", 0.0)
              for t in rng.choice([0, 0, 0, 0.3, 1.2], size=120)]
    logs = []
    for breaker in (jserve.CircuitBreaker, CircuitBreaker):
        now = {"t": 0.0}
        cb = breaker(window=6, failure_rate=0.5, min_samples=3, cooldown_s=1.0, clock=lambda: now["t"])
        log = []
        for ev, dt in stream:
            if ev == "tick":
                now["t"] += dt
            elif ev == "fail":
                cb.record_failure()
            else:
                cb.record_success()
            log.append((cb.allow(), cb.state, cb.n_opens))
        logs.append(log)
    assert logs[0] == logs[1]
    assert {s for _, s, _ in logs[1]} == {"closed", "open", "half_open"}


def test_fallback_scores_equal_jax():
    (structs, jstructs) = _structures(3, seed=9)
    metrics = ("latency_p", "throughput", "success", "backpressure")
    for (q, c), (jq, jc) in zip(structs, jstructs):
        assert heuristic_placement(q, c).assignment == jserve.lifecycle.heuristic_placement(jq, jc).assignment
        a = _cands(q, c, 12, 4)
        want = jserve.fallback_scores(jq, jc, a, metrics)
        got = fallback_scores(q, c, a, metrics)
        for m in metrics:
            np.testing.assert_array_equal(got[m], want[m])
            assert got[m].dtype == want[m].dtype


def test_shadow_verdict_matches_jax(bundles):
    """Live bundle A, candidate bundle B, one deterministic drain of score
    requests: both packages mirror the same requests and reach the same
    verdict, its statistics within 1e-6."""
    (a_models, a_dir), (b_models, b_dir) = bundles
    (structs, jstructs) = _structures(3, seed=71)
    verdicts = []
    for est, cand, sts, svc_cls, swap_cls in (
        (_port(a_dir), _port(b_dir), structs, PlacementService, BundleSwapper),
        (jserve.CostEstimator(a_models), jserve.CostEstimator(b_models), jstructs, jserve.PlacementService,
         jserve.BundleSwapper),
    ):
        mod = policy if svc_cls is PlacementService else jpolicy
        svc = svc_cls(est, auto_start=False, policy=mod.DispatchPolicy(**{**_LIFE, "shadow_fraction": 0.7}),
                      double_buffer=False)
        swapper = swap_cls(svc, seed=4)
        swapper.start_shadow(cand)
        futs = [svc.submit_score(q, c, _cands(q, c, 6, 70 + i), METRICS) for i, (q, c) in enumerate(sts * 3)]
        svc.start()
        for f in futs:
            assert f.exception(timeout=60) is None
        assert swapper.drain_shadow(timeout=60)
        verdicts.append(swapper.verdict())
        swapper.close()
        svc.close()
    ours, theirs = verdicts
    assert (ours.accepted, ours.n_mirrored, ours.n_dropped, ours.n_candidate_errors) == (
        theirs.accepted, theirs.n_mirrored, theirs.n_dropped, theirs.n_candidate_errors)
    assert ours.n_mirrored >= 3 and ours.thresholds == theirs.thresholds
    # random weights put some live costs near zero, so the mean relative error
    # is large (about 5e4 here): it is held within 1e-6 of JAX's, relative
    assert abs(ours.rank_corr - theirs.rank_corr) <= 1e-6
    np.testing.assert_allclose(ours.rel_err, theirs.rel_err, rtol=1e-6, atol=1e-6)


# -- the service against the JAX service ------------------------------------------


@pytest.mark.parametrize("double_buffer", [False, True], ids=["serial", "double_buffer"])
@pytest.mark.parametrize("cross_query", [True, False], ids=["cross_query", "per_structure"])
def test_service_matches_jax(pair, cross_query, double_buffer):
    """One pre-queued drain in each package: six small score requests over
    three structures (dispatch-bound: merged when ``cross_query``), three of
    40 candidates on another metrics tuple (compute-bound: per structure),
    and two estimate requests."""
    jest, est = pair
    (structs, jstructs), (traces, jtraces) = _structures(3), _traces(7, seed=8)
    small = [_cands(q, c, 3, 100 + i) for i, (q, c) in enumerate(structs * 2)]
    large = [_cands(q, c, 40, 200 + i) for i, (q, c) in enumerate(structs)]
    answers, counts = [], []
    for svc, sts, tr in (
        (PlacementService(est, auto_start=False, cross_query=cross_query, double_buffer=double_buffer), structs, traces),
        (jserve.PlacementService(jest, auto_start=False, cross_query=cross_query, double_buffer=double_buffer),
         jstructs, jtraces),
    ):
        futs = [svc.submit_score(q, c, a) for (q, c), a in zip(sts * 2, small)]
        futs += [svc.submit_score(q, c, a, ("latency_p",)) for (q, c), a in zip(sts, large)]
        futs += [svc.submit_estimate(tr[:3]), svc.submit_estimate(tr[3:])]
        svc.start()
        answers.append([f.result(timeout=60) for f in futs])
        svc.close()
        counts.append(_counts(svc.stats))
    for i, (got, want) in enumerate(zip(*answers)):
        _close(got, want, f"request {i}")
    assert counts[0] == counts[1]
    assert counts[0]["n_cross_query"] == (6 if cross_query else 0)


def test_service_cross_query_off_restores_per_structure_drain(pair):
    """The torch mirror of tests/test_serve.py's test of the same name, at
    the bound of its neighbour ``test_service_coalesces_score_requests``: the
    service scores both requests of a structure in one forward, the direct
    call one request at a time, so the reduction order (not the math) may
    differ by an ulp."""
    _, est = pair
    (structs, _) = _structures(2, seed=19)
    reqs = [(q, c, _cands(q, c, 6, 19 + i)) for i, (q, c) in enumerate(structs * 2)]
    svc = PlacementService(est, auto_start=False, cross_query=False)
    futs = [svc.submit_score(q, c, a) for q, c, a in reqs]
    svc.start()
    got = [f.result(timeout=60) for f in futs]
    svc.close()
    for (q, c, a), have in zip(reqs, got):
        want = est.score(q, c, a)
        for m in want:
            np.testing.assert_allclose(have[m], want[m], rtol=1e-5, atol=1e-6, err_msg=m)
    assert svc.stats.n_forwards == 2 and svc.stats.n_cross_query == 0


def test_service_coalesces_score_requests(pair):
    _, est = pair
    (structs, _) = _structures(1, seed=17)
    q, c = structs[0]
    reqs = [_cands(q, c, 6, 17 + i) for i in range(5)]
    svc = PlacementService(est, auto_start=False)
    futs = [svc.submit_score(q, c, a) for a in reqs]
    svc.start()
    got = [f.result(timeout=60) for f in futs]
    svc.close()
    for a, have in zip(reqs, got):
        want = est.score(q, c, a)
        for m in want:
            np.testing.assert_allclose(have[m], want[m], rtol=1e-5, atol=1e-6, err_msg=m)
    assert (svc.stats.n_batches, svc.stats.n_forwards, svc.stats.n_coalesced) == (1, 1, 5)


def test_exceptions_are_delivered_per_future_and_no_batchmate_fails(pair):
    _, est = pair
    (structs, _) = _structures(3, seed=67)
    good = [(q, c, _cands(q, c, 4, 67 + i)) for i, (q, c) in enumerate(structs)]
    q0, c0, a0 = good[0]
    svc = PlacementService(est, auto_start=False)
    futs = [svc.submit_score(q, c, a, ("latency_p",)) for q, c, a in good]
    bad = svc.submit_score(q0, c0, np.zeros((0, a0.shape[1]), dtype=np.int64), ("latency_p",))
    svc.start()
    with pytest.raises(ValueError, match="no candidates"):
        bad.result(timeout=60)
    for (q, c, a), f in zip(good, futs):
        np.testing.assert_allclose(f.result(timeout=60)["latency_p"], est.score(q, c, a, ("latency_p",))["latency_p"],
                                   rtol=1e-4, atol=1e-6)
    assert svc.stats.n_cross_query == 3 and svc.stats.n_failed == 0
    ok = svc.score(q0, c0, a0, ("latency_p",))  # the worker survived the failed request
    assert ok["latency_p"].shape == (len(a0),)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_score(q0, c0, a0)
    never = PlacementService(est, auto_start=False)
    orphan = never.submit_score(q0, c0, a0)
    never.close()
    with pytest.raises(RuntimeError, match="closed before start"):
        orphan.result(timeout=60)


def test_overload_rejects_or_blocks_at_the_queue_bound(pair):
    _, est = pair
    (structs, _) = _structures(1, seed=5)
    q, c = structs[0]
    a = _cands(q, c, 2, 5)
    svc = PlacementService(est, auto_start=False, max_queue_depth=2)
    futs = [svc.submit_score(q, c, a) for _ in range(2)]
    with pytest.raises(ServiceOverloadError, match="max_queue_depth"):
        svc.submit_score(q, c, a)
    assert svc.stats.n_rejected == 1
    svc.start()
    assert all(f.exception(timeout=60) is None for f in futs)
    svc.close()

    blocking = PlacementService(est, auto_start=False, max_queue_depth=1, overflow="block")
    first = blocking.submit_score(q, c, a)
    later = []
    producer = threading.Thread(target=lambda: later.append(blocking.submit_score(q, c, a)))
    producer.start()
    producer.join(timeout=0.2)
    assert producer.is_alive() and not later, "the producer must wait at the bound"
    blocking.start()
    producer.join(timeout=60)
    assert not producer.is_alive() and first.exception(timeout=60) is None
    assert later[0].exception(timeout=60) is None and blocking.stats.n_rejected == 0
    blocking.close()


def test_oversized_groups_are_chunked(pair):
    _, est = pair
    (structs, _) = _structures(1, seed=37)
    q, c = structs[0]
    reqs = [_cands(q, c, 4, 37 + i) for i in range(6)]
    svc = PlacementService(est, max_batch=8, auto_start=False)
    futs = [svc.submit_score(q, c, a, ("latency_p",)) for a in reqs]
    svc.start()
    for a, f in zip(reqs, futs):
        np.testing.assert_allclose(f.result(timeout=60)["latency_p"], est.score(q, c, a, ("latency_p",))["latency_p"],
                                   rtol=1e-5, atol=1e-6)
    svc.close()
    assert svc.stats.n_forwards == 3  # 24 rows / max_batch 8
    traces, _ = _traces(5, seed=41)
    g = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])
    want = est.estimate(g, ("latency_p",))["latency_p"]
    svc = PlacementService(est, max_batch=4, auto_start=False)
    futs = [svc.submit_estimate(g, ("latency_p",)) for _ in range(2)]
    svc.start()
    for f in futs:
        np.testing.assert_allclose(f.result(timeout=60)["latency_p"], want, rtol=1e-4, atol=1e-6)
    svc.close()
    assert svc.stats.n_forwards == 3  # 10 graphs / max_batch 4


def test_swap_bundle_at_a_drain_boundary_loses_no_request(bundles):
    (_, a_dir), (_, b_dir) = bundles
    est_a, est_b = _port(a_dir), _port(b_dir)
    (structs, _) = _structures(2, seed=13)
    svc = PlacementService(est_a, policy=policy.DispatchPolicy(**_LIFE))
    q, c = structs[0]
    a = _cands(q, c, 3, 0)
    before = svc.score(q, c, a, METRICS)
    futs = [svc.submit_score(qq, cc, _cands(qq, cc, 3, i), METRICS) for i, (qq, cc) in enumerate(structs * 4)]
    old = svc.swap_bundle(est_b, wait=True)
    futs += [svc.submit_score(qq, cc, _cands(qq, cc, 3, 9 + i), METRICS) for i, (qq, cc) in enumerate(structs * 4)]
    assert old is est_a and svc.estimator is est_b and svc.stats.n_swaps == 1
    assert all(f.exception(timeout=60) is None for f in futs), "no request lost across the swap"
    after = svc.score(q, c, a, METRICS)
    assert not np.allclose(before["latency_p"], after["latency_p"])
    np.testing.assert_allclose(after["latency_p"], est_b.score(q, c, a, METRICS)["latency_p"], rtol=1e-5, atol=1e-7)
    # a bundle (not an estimator) swaps in on the live estimator's device
    svc.swap_bundle(CostModelBundle.load(a_dir), wait=True)
    assert svc.estimator.device.type == "cpu" and svc.stats.n_swaps == 2
    svc.close()
    assert svc.stats.n_drained == svc.stats.n_requests


def test_breaker_opens_on_raising_estimator_serves_degraded_then_recovers(bundles):
    (_, a_dir), _ = bundles
    est = _port(a_dir)
    (structs, _) = _structures(2, seed=29)
    fault = chaos.RaiseFault(p=1.0, seed=0)
    # per-structure drains: a raise at launch fails its subgroup only, which
    # is retried and then answered from the fallback (a merged drain that
    # raises at launch delivers the error, as in the JAX package)
    svc = PlacementService(est, policy=policy.DispatchPolicy(**_LIFE), cross_query=False)
    est.add_hook(fault)
    try:
        futs = [svc.submit_score(q, c, _cands(q, c, 3, i), METRICS) for i, (q, c) in enumerate(structs * 4)]
        answers = [f.result(timeout=60) for f in futs]  # degraded, never raised
        assert all(getattr(x, "degraded", False) for x in answers)
        assert svc.stats.n_failed == 0 and svc.stats.n_retries >= 1 and svc.breaker.state != "closed"
    finally:
        est.remove_hook(fault)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        time.sleep(_LIFE["breaker_cooldown_s"])
        ans = [svc.submit_score(q, c, _cands(q, c, 2, 5), METRICS).result(timeout=60) for q, c in structs]
        if svc.breaker.state == "closed" and not any(getattr(x, "degraded", False) for x in ans):
            break
    else:
        pytest.fail("the breaker never closed after the fault cleared")
    svc.close()


# -- load --------------------------------------------------------------------------


@pytest.mark.parametrize("rate,n,seed", [(5.0, 40, 0), (250.0, 300, 7), (1e4, 1000, 3)])
def test_arrival_schedules_are_bitwise_jax(rate, n, seed):
    np.testing.assert_array_equal(load.poisson_arrivals(rate, n, seed), jload.poisson_arrivals(rate, n, seed))
    for kw in ({}, {"burst_factor": 3.0, "burst_fraction": 0.5, "period_s": 0.25}, {"burst_factor": 10.0}):
        np.testing.assert_array_equal(load.bursty_arrivals(rate, n, seed, **kw), jload.bursty_arrivals(rate, n, seed, **kw))


def test_latency_quantiles_and_knee_match_jax():
    lat = np.random.default_rng(1).lognormal(-4, 1, 500)
    assert load.latency_quantiles(lat) == jload.latency_quantiles(lat)
    assert all(np.isnan(v) for v in load.latency_quantiles([]))

    def stub(mod):
        def run_at_rate(rate):
            p95 = 0.01 * rate / 40.0
            return mod.LoadReport(10, 10, 0, 0, 1.0, rate, rate, np.zeros(10), 0.0, p95, p95, 0.25, 0,
                                  0.0 if p95 <= 0.25 else 0.5)
        return run_at_rate

    rates = [50, 200, 400, 800, 1000, 1200, 2000, 4000]
    ours, theirs = load.find_knee(stub(load), rates, 0.25), jload.find_knee(stub(jload), rates, 0.25)
    assert ours[0] == theirs[0] == 1000
    assert [(p.rate, p.p95_s, p.slo_violation_rate) for p in ours[1]] == [
        (p.rate, p.p95_s, p.slo_violation_rate) for p in theirs[1]]


def test_open_loop_run_answers_every_request(pair):
    _, est = pair
    (structs, _) = _structures(2, seed=55)
    svc = PlacementService(est)
    fire = load.score_request_stream(structs, 24, 3, seed=1)(svc)
    svc.warm(structs, max_cands=4)
    rep = load.run_open_loop(svc, fire, load.poisson_arrivals(200.0, 24, seed=2), slo_s=5.0, timeout_s=60)
    svc.close()
    assert rep.n_answered == rep.n_requests == 24 and rep.n_failed == rep.n_rejected == 0
    assert rep.latencies_s.shape == (24,) and np.isfinite(rep.latencies_s).all()
    assert rep.stats.n_drained == 24 and rep.summary()["n_answered"] == 24
