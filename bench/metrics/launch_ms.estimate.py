"""``launch_ms.estimate``: the mean host-clock time of an ``estimate`` / ``estimate_many`` call
from its start to the return of its deferred handle (merge, copies to the device, launches),
over the window's calls."""

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES or not run.calls:
        return None
    return 1e3 * sum(c.t_dispatched - c.t_start for c in run.calls) / len(run.calls)
