"""Serving: the versioned model bundle, the ``CostEstimator`` facade, fused
multi-metric ensembles and the dispatch policy (the port of ``repro.serve``)."""
