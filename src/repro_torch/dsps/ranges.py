"""Feature ranges of the synthetic training corpus (paper Table II).

These ranges drive both the workload generator (sampling) and the feature
normalization of the cost model (log-scale min/max). Evaluation-time
interpolation/extrapolation experiments (Exp 3/4) construct shifted copies.
"""

from __future__ import annotations

# --- hardware-related (Table II) -------------------------------------------
CPU = [50, 100, 200, 300, 400, 500, 600, 700, 800]  # % of a reference core
RAM_MB = [1000, 2000, 4000, 8000, 16000, 24000, 32000]
BANDWIDTH_MBPS = [25, 50, 100, 200, 400, 800, 1600, 3200, 6400, 10000]
LATENCY_MS = [1, 2, 5, 10, 20, 40, 80, 160]

# --- data-related ------------------------------------------------------------
EVENT_RATE_LINEAR = [100, 200, 400, 800, 1600, 3200, 6400, 12800, 25600]
EVENT_RATE_TWO_WAY = [50, 100, 250, 500, 750, 1000, 1250, 1500, 1750, 2000]
EVENT_RATE_THREE_WAY = [20, 50, 100, 200, 300, 400, 500, 600, 700, 800, 900, 1000]
TUPLE_WIDTHS = list(range(3, 11))  # [3..10] attributes per tuple
DTYPES = ["int", "double", "string"]

# --- operator-related --------------------------------------------------------
FILTER_FNS = ["<", ">", "<=", ">=", "!=", "startswith", "endswith"]
LITERAL_DTYPES = ["int", "string", "double"]
WINDOW_TYPES = ["sliding", "tumbling"]
WINDOW_POLICIES = ["count", "time"]
WINDOW_SIZE_COUNT = [5, 10, 20, 40, 80, 160, 320, 640]  # tuples
WINDOW_SIZE_TIME = [0.25, 0.5, 1, 2, 4, 8, 16]  # seconds
SLIDE_RATIO = (0.3, 0.7)  # x window length
JOIN_KEY_DTYPES = ["int", "string", "double"]
AGG_FNS = ["min", "max", "mean", "sum"]
GROUP_BY_DTYPES = ["int", "string", "double", "none"]

# Selectivity sampling (not in Table II; paper Definitions 6-8 bound them [0,1]).
FILTER_SEL_LOG10 = (-2.0, 0.0)  # 0.01 .. 1.0
JOIN_SEL_LOG10 = (-3.0, -0.5)  # 0.001 .. ~0.316 of the cartesian product
AGG_SEL_LOG10 = (-2.0, 0.0)  # distinct groups / window length

# Query mix of the benchmark corpus (paper SVI): linear / 2-way / 3-way joins.
QUERY_MIX = {"linear": 0.35, "two_way": 0.34, "three_way": 0.31}
# #filters distribution: 35% 1, 34% 2, 24% 3, 6% 4 (paper SVI); renormalized.
FILTER_COUNT_P = {1: 0.35, 2: 0.34, 3: 0.24, 4: 0.06}
AGG_PROBABILITY = 0.5

# Log-normalization bounds used by the transferable featurization. Chosen to
# cover the training ranges with generous head-room so that *extrapolation*
# (Exp 4) stays inside finite normalized values rather than clipping.
LOG_BOUNDS = {
    "cpu": (10.0, 3200.0),
    "ram_mb": (250.0, 128000.0),
    "bandwidth_mbps": (5.0, 40000.0),
    "latency_ms": (0.25, 640.0),
    "event_rate": (5.0, 102400.0),
    "tuple_width": (1.0, 40.0),
    "selectivity": (1e-4, 1.0),
    "window_count": (1.0, 2560.0),
    "window_time_s": (0.05, 64.0),
}


def interpolation_ranges() -> dict:
    """Unseen-but-in-range hardware values (paper Table IV (A))."""
    return {
        "CPU": [75, 150, 250, 350, 450, 550, 650, 750],
        "RAM_MB": [1500, 3000, 6000, 12000, 20000, 28000],
        "BANDWIDTH_MBPS": [35, 75, 150, 250, 550, 1200, 1900, 4800, 8000],
        "LATENCY_MS": [3, 7, 15, 30, 60, 120],
    }


def extrapolation_ranges() -> dict:
    """Reduced training ranges + out-of-range eval values (paper Table V)."""
    return {
        "stronger": {
            "train": {
                "RAM_MB": [1000, 2000, 4000, 8000, 16000],
                "CPU": [50, 100, 200, 300, 400, 500, 600],
                "BANDWIDTH_MBPS": [25, 50, 100, 200, 400, 800, 1600, 3200],
                "LATENCY_MS": [5, 10, 20, 40, 80, 160],
            },
            "eval": {
                "RAM_MB": [24000, 32000],
                "CPU": [700, 800],
                "BANDWIDTH_MBPS": [6400, 10000],
                "LATENCY_MS": [1, 2],
            },
        },
        "weaker": {
            "train": {
                "RAM_MB": [4000, 8000, 16000, 24000, 32000],
                "CPU": [200, 300, 400, 500, 600, 700, 800],
                "BANDWIDTH_MBPS": [100, 200, 400, 800, 1600, 3200, 6400, 10000],
                "LATENCY_MS": [1, 2, 5, 10, 20, 40],
            },
            "eval": {
                "RAM_MB": [1000, 2000],
                "CPU": [50, 100],
                "BANDWIDTH_MBPS": [25, 50],
                "LATENCY_MS": [80, 160],
            },
        },
    }
