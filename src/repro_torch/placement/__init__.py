"""Placement selection with COSTREAM (paper SV): candidate enumeration, the
cost-based optimizer over the port's ``CostEstimator``, and the
online-monitoring rescheduling baseline (a pinned copy)."""

from repro_torch.placement.baselines import online_monitoring_run, MonitoringResult
