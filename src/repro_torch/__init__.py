"""COSTREAM on PyTorch and CUDA: the port of the ``repro`` package.

The serving path — featurize a joint operator-resource graph, run the 3-stage
message-passing GNN ensembles, vote the per-metric costs — with its two
kernels (``banked_mlp``, ``mp_update``) hand-written in CUDA C++ for Hopper
(``csrc/``).  The port imports nothing of ``repro`` and no JAX.
"""

from repro_torch.core.model import CostModelConfig
from repro_torch.dsps.generator import WorkloadGenerator
from repro_torch.placement.optimizer import PlacementOptimizer
from repro_torch.serve.bundle import CostModelBundle
from repro_torch.serve.estimator import CostEstimator

__all__ = [
    "CostEstimator",
    "CostModelBundle",
    "CostModelConfig",
    "PlacementOptimizer",
    "WorkloadGenerator",
]
