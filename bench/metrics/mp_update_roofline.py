"""``mp_update_roofline``: the ``mp_update`` launches of the traced stretch against their least
time on this card (``bench/counts/mp_update.py``; ``harness/peaks.py:roofline``)."""

from bench.harness import peaks


def read(run):
    return peaks.roofline(run, "mp_update")
