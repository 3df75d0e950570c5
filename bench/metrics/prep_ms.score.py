"""``prep_ms.score``: the host's preparation inside a call's dispatch: mean per call of the self
time of the ``host.featurize``, ``host.merge``, ``host.keys``, ``host.group``, ``host.a_place`` and
``host.banding`` spans, over the traced stretch's ``score_many`` calls (``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("score_many",)


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.per_call_ms(spans.PREP)
