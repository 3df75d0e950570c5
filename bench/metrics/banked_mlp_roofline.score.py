"""``banked_mlp_roofline.score``: the ``banked_mlp`` launches of the traced stretch's ``score_many``
calls (stages 0 to 2 and each stage-3 level) against their least time on this card
(``bench/counts/banked_mlp.py``; ``harness/peaks.py:roofline``)."""

from bench.harness import peaks


def read(run):
    return peaks.roofline(run, "banked_mlp", ("score_many",))
