"""``mp_sweep_roofline``: the ``mp_sweep`` launches of the traced stretch against their least time
on this card (``bench/counts/mp_sweep.py``; ``harness/peaks.py:roofline``)."""

from bench.harness import peaks


def read(run):
    return peaks.roofline(run, "mp_sweep")
