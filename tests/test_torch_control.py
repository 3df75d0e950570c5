"""The port's fleet controller (``control/*``) and fault monitor
(``launch/faults.py``) against the JAX package.

The numpy-only modules are pinned copies: each equals its original apart
from the package name in its imports.  Driven with the same inputs, the
fault monitor gives the same events, and a seeded drift-and-failure fleet
scored by the noise-free simulator gives the same ``ControllerReport`` tick
by tick.  Scored by ``CostEstimator``s of both packages over one JAX-written
bundle, the re-planner's scores agree within ``rtol=1e-4, atol=1e-6`` and its
decisions are equal; a decision that flips fails with both sides' margins.
"""

from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.control as jcontrol
import repro.core as jcore
import repro.launch.faults as jfaults
import repro.serve as jserve
from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.dsps.hardware import Cluster as JaxCluster, HardwareNode as JaxNode
from repro_torch import control
from repro_torch.dsps import WorkloadGenerator
from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.launch import faults
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator
from repro_torch.serve.policy import active_policy

REPO = Path(__file__).resolve().parents[1]
METRICS = ("latency_e", "success", "backpressure")


# -- pinned copies ------------------------------------------------------------------

PINNED = [
    "placement/baselines.py",
    "dsps/benchmarks.py",
    "serve/chaos.py",
    "launch/faults.py",
    "control/__init__.py",
    "control/telemetry.py",
    "control/detect.py",
    "control/replan.py",
    "control/scenario.py",
    "control/controller.py",
]


@pytest.mark.parametrize("module", PINNED)
def test_copied_module_equals_its_original_apart_from_imports(module):
    ours = (REPO / "src" / "repro_torch" / module).read_text()
    theirs = (REPO / "src" / "repro" / module).read_text()
    assert "jax" not in ours
    assert ours.replace("repro_torch.", "repro.") == theirs, f"{module} drifted from src/repro/{module}"


# -- launch/faults.py ---------------------------------------------------------------


def _fault_run(mod):
    saved = []
    log = []

    def train_epoch(step, n_hosts):
        log.append((step, n_hosts))
        return step + 10

    monitor = mod.ClusterMonitor(n_hosts=6)
    end, events = mod.run_with_faults(
        train_epoch, saved.append, lambda: saved[-1] if saved else None, monitor,
        {20: ("fail", 2), 45: ("straggle", 4), 70: ("fail", 0)}, total_steps=120,
    )
    detect = mod.ClusterMonitor(n_hosts=4)
    for h in range(4):
        detect.heartbeat(h, 0.0)
        detect.report_step(h, 0.1 * (8.0 if h == 1 else 1.0))
    detect.inject_failure(3)
    now = detect.policy.heartbeat_timeout_s + 1
    for h in range(3):  # host 3 failed: it stops heartbeating
        detect.heartbeat(h, now)
    outliers = mod.straggler_outliers(dict(enumerate([0.1, 0.11, 0.1, 0.9, 0.12])), 3.0)
    return end, [vars(e) for e in events], log, saved, detect.detect(now), list(outliers), detect.n_alive()


def test_run_with_faults_and_cluster_monitor_match_jax():
    ours, theirs = _fault_run(faults), _fault_run(jfaults)
    assert ours == theirs
    end, events, _, _, detected, _, _ = ours
    assert end >= 120 and len(events) >= 2 and 3 in [h for h, _ in detected]


# -- the controller on the simulator oracle -------------------------------------------


@pytest.fixture(scope="module")
def scenario():
    """A small seeded drift-and-failure fleet in both packages."""
    return control.build_scenario(4, 14, seed=7), jcontrol.build_scenario(4, 14, seed=7)


def _report_rows(rep):
    """Everything a ``ControllerReport`` records except the wall-clock times."""
    rows = [(r.tick, r.fleet_cost_ms, [(a.query_id, a.kind, a.tick) for a in r.alarms],
             [d.to_dict() for d in r.decisions], r.replan_latency_s is None, r.degraded) for r in rep.records]
    d = rep.to_dict()
    return rows, {k: v for k, v in d.items() if not k.startswith("replan_p")}


def test_scenario_fleet_equals_jax(scenario):
    (fleet, cluster, events), (jfleet, jcluster, jevents) = scenario
    assert [(q.name, a) for q, a in fleet] == [(q.name, a) for q, a in jfleet]
    assert [vars(n) for n in cluster.nodes] == [vars(n) for n in jcluster.nodes]
    assert [(e.tick, e.kind, e.query, e.host, e.factor) for e in events] == [
        (e.tick, e.kind, e.query, e.host, e.factor) for e in jevents]


@pytest.mark.parametrize("kind", ["controller", "static"])
def test_simulator_scored_reports_match_jax_tick_by_tick(scenario, kind):
    reports = []
    for mod, (fleet, cluster, events) in zip((control, jcontrol), scenario):
        rt = mod.FleetRuntime(fleet, cluster, events, seed=3)
        if kind == "static":
            reports.append(mod.run_static(rt, 14))
        else:
            reports.append(mod.PlacementController(rt, scorer=mod.SimulatorScorer(), seed=0).run(14))
    ours, theirs = (_report_rows(r) for r in reports)
    assert ours == theirs
    if kind == "controller":
        assert reports[0].n_replans > 0 and ours[0][-1][3] is not None


def test_degraded_probe_defers_soft_replans_as_jax(scenario):
    logs = []
    for mod, (fleet, cluster, events) in zip((control, jcontrol), scenario):
        ticks = iter(range(100))
        ctl = mod.PlacementController(mod.FleetRuntime(fleet, cluster, events, seed=3), scorer=mod.SimulatorScorer(),
                                      seed=0, degraded=lambda: next(ticks) < 6)
        logs.append(_report_rows(ctl.run(10)))
    assert logs[0] == logs[1]
    assert any(row[5] for row in logs[0][0])


def test_policy_controller_knobs_validate():
    pol = active_policy()
    for field, bad in [("controller_tick_s", 0.0), ("detector_window", 0), ("drift_threshold", -1.0),
                       ("migration_budget_mb", -0.5), ("replan_cooldown_ticks", -1), ("replan_k", 0)]:
        with pytest.raises(ValueError, match=field):
            dc_replace(pol, **{field: bad}).validate()
    dc_replace(pol, migration_budget_mb=0.0, replan_cooldown_ticks=0).validate()


# -- the controller on estimators of both packages --------------------------------------


@pytest.fixture(scope="module")
def estimators(tmp_path_factory):
    models = {}
    for i, m in enumerate(METRICS):
        cfg = jcore.CostModelConfig(metric=m, n_ensemble=2, gnn=jcore.GNNConfig(hidden=16, use_pallas=True))
        models[m] = (jcore.init_cost_model(jax.random.PRNGKey(30 + i), cfg), cfg)
    d = str(tmp_path_factory.mktemp("control") / "bundle")
    jserve.CostModelBundle(models).save(d)
    return CostEstimator.from_bundle(CostModelBundle.load(d), device="cpu"), jserve.CostEstimator(models)


def _key(d):
    """A decision's choice: everything but its float costs."""
    x = d.to_dict()
    return {k: v for k, v in x.items() if k not in ("predicted_cost", "current_cost", "gain")}


def _same_decisions(ours, theirs, min_gain=0.05):
    """Equal choices, costs within the serving bound; a flip fails with both
    sides' gains against the hysteresis margin (the margin the choice turned on)."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if _key(a) != _key(b):
            pytest.fail(f"query {a.query_id}: the port chose {a.action} {a.new} (gain {a.gain:.6g}, cost "
                        f"{a.predicted_cost:.6g}), JAX {b.action} {b.new} (gain {b.gain:.6g}, cost "
                        f"{b.predicted_cost:.6g}); margin to min_gain {min_gain}: {a.gain - min_gain:.3g} / "
                        f"{b.gain - min_gain:.3g}")
        np.testing.assert_allclose([a.predicted_cost, a.current_cost], [b.predicted_cost, b.current_cost],
                                   rtol=1e-4, atol=1e-6)


def _replan_items(mod, gen, seed):
    cluster = mod is control and Cluster or JaxCluster
    node = mod is control and HardwareNode or JaxNode
    cl = cluster([node(0, 150, 4000, 200, 10), node(1, 300, 8000, 400, 5), node(2, 150, 4000, 200, 10)])
    qs = [gen.query(kind=k, name=f"rp{i}") for i, k in enumerate(("linear", "two_way", "linear"))]
    rt = mod.FleetRuntime([(q, (i % 3,) * q.n_ops()) for i, q in enumerate(qs)], cl, seed=seed, tick_s=30.0)
    return [mod.ReplanItem(query_id=qid, query=rt.query(qid), cluster=rt.observed_cluster(qid),
                           current=tuple(int(x) for x in rt.assignment(qid)),
                           free_ops=tuple(range(rt.query(qid).n_ops())),
                           state_mb=tuple(float(x) for x in rt.state_mb(qid)))
            for qid in range(3)]


def test_replanner_scores_and_decisions_match_jax(estimators):
    est, jest = estimators
    items, jitems = _replan_items(control, WorkloadGenerator(seed=11), 0), _replan_items(jcontrol, JaxGenerator(seed=11), 0)
    rp = control.Replanner(estimator=est, budget_mb=64.0, replan_k=12)
    jrp = jcontrol.Replanner(estimator=jest, budget_mb=64.0, replan_k=12)
    cands = [c for c in (np.asarray(x) for x in [np.repeat([it.current], 3, 0) for it in items])]
    for got, want in zip(rp._score_all(items, cands), jrp._score_all(jitems, cands)):
        for m in METRICS:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-6, err_msg=m)
    for seed_key in ((0, 1), (0, 2), (5, 9)):
        _same_decisions(rp.replan_many(items, seed_key=seed_key), jrp.replan_many(jitems, seed_key=seed_key))


def test_estimator_scored_controller_matches_jax(estimators, scenario):
    est, jest = estimators
    reports = []
    for mod, e, (fleet, cluster, events) in zip((control, jcontrol), (est, jest), scenario):
        ctl = mod.PlacementController(mod.FleetRuntime(fleet, cluster, events, seed=3), estimator=e, seed=0)
        reports.append(ctl.run(10))
    ours, theirs = reports
    assert [r.tick for r in ours.records] == [r.tick for r in theirs.records]
    for a, b in zip(ours.records, theirs.records):
        assert [(x.query_id, x.kind) for x in a.alarms] == [(x.query_id, x.kind) for x in b.alarms]
        _same_decisions(a.decisions, b.decisions)
        assert a.fleet_cost_ms == b.fleet_cost_ms  # the simulator is the same numpy code on the same placements
    assert ours.n_replans == theirs.n_replans > 0
