"""COSTREAM core in PyTorch: joint graphs, featurization, the 3-stage GNN and
the per-metric ensembles (the port of ``repro.core``), and the flat-vector
baseline."""

from repro_torch.core.flat_vector import (
    FLAT_DIM,
    FlatVectorConfig,
    featurize_flat,
    featurize_flat_traces,
    forward_flat,
    init_flat_model,
)
