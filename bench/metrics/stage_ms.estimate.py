"""``stage_ms.estimate``: the copies to the device: mean per call of the ``h2d.stage`` spans
(packing into the page-locked buffer, its allocation, the copy's enqueue), those inside the forward
included, over the traced stretch's ``estimate`` / ``estimate_many`` calls
(``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.per_call_ms(("h2d.stage",), own=False)
