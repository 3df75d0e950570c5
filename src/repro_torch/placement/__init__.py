"""Placement selection with COSTREAM (paper SV): candidate enumeration and the
cost-based optimizer over the port's ``CostEstimator``."""
