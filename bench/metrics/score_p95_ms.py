"""``score_p95_ms``: the 95th percentile, over every call of the window, of the host-clock time
from the start of a ``score_many`` call to its answers in hand (linear interpolation)."""

import numpy as np


def read(run):
    if run.entry != "score_many" or not run.calls:
        return None
    return float(np.percentile([(c.t_done - c.t_start) * 1e3 for c in run.calls], 95))
