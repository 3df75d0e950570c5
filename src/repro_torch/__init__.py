"""COSTREAM on PyTorch and CUDA: the port of the ``repro`` package.

The COSTREAM serving paths — featurize a joint operator-resource graph, run
the 3-stage message-passing GNN ensembles, vote the per-metric costs, for one
request (``estimate`` / ``score`` / ``optimize``) or across many
(``estimate_many`` / ``score_many``) — their training, the LM stack's
RecurrentGemma-2B (``models/``, ``configs/``: prefill into the decode cache,
cached decode, the train step) and the distribution substrate
(``distributed/``: the data-parallel step, the pipeline, sharding rules).  Six kernels carry them, hand-written in CUDA C++ for Hopper
(``csrc/``): ``banked_mlp``, ``mp_update``, ``mp_sweep``, ``gather_sum``,
``segment_sum`` and the RG-LRU ``linear_scan``.  The port imports nothing of
``repro`` and no JAX.
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
