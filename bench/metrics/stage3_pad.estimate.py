"""``stage3_pad.estimate``: stage-3 rows computed per real row: over the stretch's ``gnn.forward``
spans, the rows their stage-3 levels cover (``rows3``) over the real operator rows at depth 1 or
more (``real3``), over the traced stretch's ``estimate`` / ``estimate_many`` calls
(``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.attr_ratio("gnn.forward", "rows3", "real3")
