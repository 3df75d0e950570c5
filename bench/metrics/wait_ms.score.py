"""``wait_ms.score``: the host waiting for the device in the finalize half: mean per call of the
``d2h.wait`` spans (the ``.cpu()`` of the raw outputs), over the traced stretch's ``score_many``
calls (``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("score_many",)


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.per_call_ms(("d2h.wait",), own=False)
