"""COSTREAM core in PyTorch: joint graphs, featurization, the 3-stage GNN and
the per-metric ensembles (the port of ``repro.core``)."""
