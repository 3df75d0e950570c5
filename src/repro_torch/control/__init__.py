"""Continuous placement control: drift-aware incremental re-placement for a
running query fleet (docs/controller.md).

The subsystem closes the loop the ROADMAP's online scenario asks for:
``FleetRuntime`` (telemetry oracle over the DSPS simulator) -> ``DriftDetector``
(EWMA/CUSUM + hard events) -> ``Replanner`` (budgeted sub-assignment search
through the fused scorer) -> ``PlacementController`` (the per-tick loop with
hysteresis, cooldown, and SLO-grade re-placement-latency reporting).
"""

from repro_torch.control.controller import (
    ControllerReport,
    PlacementController,
    TickRecord,
    run_static,
)
from repro_torch.control.detect import Alarm, DriftDetector
from repro_torch.control.replan import MigrationDecision, ReplanItem, Replanner
from repro_torch.control.scenario import build_scenario, fleet_queries, weak_cluster
from repro_torch.control.telemetry import (
    FleetRuntime,
    FleetSnapshot,
    HostObs,
    QueryObs,
    ScenarioEvent,
    SimulatorScorer,
    plan_initial_fleet,
    seeded_events,
)

__all__ = [
    "Alarm",
    "ControllerReport",
    "DriftDetector",
    "FleetRuntime",
    "FleetSnapshot",
    "HostObs",
    "MigrationDecision",
    "PlacementController",
    "QueryObs",
    "ReplanItem",
    "Replanner",
    "ScenarioEvent",
    "SimulatorScorer",
    "TickRecord",
    "build_scenario",
    "fleet_queries",
    "plan_initial_fleet",
    "run_static",
    "seeded_events",
    "weak_cluster",
]
