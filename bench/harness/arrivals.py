"""Seeded open-loop arrival schedules, for cells that offer load at a fixed rate.

A frozen copy of ``poisson_arrivals`` and ``bursty_arrivals`` from the port's ``serve/load.py``
(the program may change; the yardstick may not).  No cell of this benchmark uses them yet: the
service cell that will (``PERF.md``, Open questions) offers its load on these schedules.
"""

from __future__ import annotations

from typing import List

import numpy as np


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds) of a Poisson process at ``rate`` requests/s."""
    if not (rate > 0 and n > 0):
        raise ValueError(f"rate {rate} and n {n} must be positive")
    return np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, size=n))


def bursty_arrivals(rate: float, n: int, seed: int = 0, burst_factor: float = 8.0,
                    burst_fraction: float = 0.2, period_s: float = 1.0) -> np.ndarray:
    """Arrival offsets of an on/off process averaging ``rate``: each ``period_s`` opens with a
    burst of ``burst_fraction`` of the period at ``burst_factor`` times the rate, then a quieter
    phase that keeps the long-run mean at ``rate``."""
    if not (rate > 0 and n > 0 and 0.0 < burst_fraction < 1.0 and burst_factor >= 1.0):
        raise ValueError("bad schedule parameters")
    burst_rate = rate * burst_factor
    quiet_weight = 1.0 - burst_factor * burst_fraction
    if quiet_weight <= 0:
        burst_rate, quiet_rate = rate / burst_fraction, 0.0
    else:
        quiet_rate = rate * quiet_weight / (1.0 - burst_fraction)
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        burst_end, period_end, cursor = t + burst_fraction * period_s, t + period_s, t
        while True:
            cursor += rng.exponential(1.0 / burst_rate)
            if cursor >= burst_end or len(out) >= n:
                break
            out.append(cursor)
        cursor = burst_end
        if quiet_rate > 0:
            while True:
                cursor += rng.exponential(1.0 / quiet_rate)
                if cursor >= period_end or len(out) >= n:
                    break
                out.append(cursor)
        t = period_end
    return np.asarray(out[:n])
