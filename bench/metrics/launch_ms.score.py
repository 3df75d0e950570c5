"""``launch_ms.score``: the mean host-clock time of a ``score_many`` call from its start to the
return of its deferred handle, over the window's calls."""


def read(run):
    if run.entry != "score_many" or not run.calls:
        return None
    return 1e3 * sum(c.t_dispatched - c.t_start for c in run.calls) / len(run.calls)
