"""DSPS substrate: query IR, hardware model, workload generator, cost simulator.

This package models the *system under study* of the COSTREAM paper: distributed
streaming queries (filter / windowed aggregation / windowed join) placed onto
heterogeneous edge-cloud hardware. The analytic simulator replaces the Apache
Storm + CloudLab measurement harness of the paper as the label oracle (see
DESIGN.md §2); everything learned on top of it is the paper's contribution.
"""

from repro_torch.dsps.query import (
    Operator,
    OpType,
    Query,
    WindowSpec,
    AggFn,
    FilterFn,
    DType,
)
from repro_torch.dsps.hardware import HardwareNode, Cluster, hardware_bin
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.simulator import simulate, CostLabels, SimulatorConfig
from repro_torch.dsps.generator import WorkloadGenerator, GeneratorConfig
from repro_torch.dsps import ranges

__all__ = [
    "Operator",
    "OpType",
    "Query",
    "WindowSpec",
    "AggFn",
    "FilterFn",
    "DType",
    "HardwareNode",
    "Cluster",
    "hardware_bin",
    "Placement",
    "simulate",
    "CostLabels",
    "SimulatorConfig",
    "WorkloadGenerator",
    "GeneratorConfig",
    "ranges",
]
