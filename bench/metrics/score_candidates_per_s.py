"""``score_candidates_per_s``: every candidate placement answered on every metric in the window,
over the window's seconds."""


def read(run):
    if run.entry != "score_many":
        return None
    return sum(c.items for c in run.calls) / run.window_s
