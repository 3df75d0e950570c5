"""The program's own spans of the traced stretch (``repro_torch.obs``), reduced per call.

While ``torch.profiler`` records, the program keeps a record of each of its spans: name, call id,
parent, start and end on the host clock, attributes.  ``repro_torch.obs.records()`` holds the
latest profiled stretch's, which is the traced stretch once the run is over.  A call is one facade
entry's dispatch (a span named ``estimator.<entry>``) and every span that shares its call id: the
spans inside it and its deferred finalize.  A span's self time is its duration less the part its
child spans cover.

Beside ``program.py``, this is the one module of the harness that imports the port, and it imports
only ``repro_torch.obs``.  Where that module is absent (a program without the spans) or holds no
call, every function here returns None.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

ENTRIES = ("estimator.estimate", "estimator.estimate_many", "estimator.score_many", "estimator.score")
PREP = ("host.featurize", "host.merge", "host.keys", "host.group", "host.a_place", "host.banding")


@dataclass
class Calls:
    n: int  # facade calls dispatched in the stretch
    self_ns: Dict[str, int]  # span name -> self time summed over the calls' spans
    total_ns: Dict[str, int]  # span name -> duration summed over the calls' spans
    attrs: Dict[str, Dict[str, float]]  # span name -> numeric attribute -> sum over the calls' spans


def calls() -> Optional[Calls]:
    """The stretch's calls, or None (no ``repro_torch.obs``, or no call recorded)."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    records = obs.records()
    ids = {r.call for r in records if r.name in ENTRIES}
    if not ids:
        return None
    covered: Dict[int, int] = defaultdict(int)  # span id -> time its children cover
    for r in records:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    self_ns: Dict[str, int] = defaultdict(int)
    total_ns: Dict[str, int] = defaultdict(int)
    attrs: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for r in records:
        if r.call not in ids:
            continue
        total_ns[r.name] += r.end_ns - r.start_ns
        self_ns[r.name] += r.end_ns - r.start_ns - covered[r.id]
        for k, v in r.attrs.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                attrs[r.name][k] += v
    return Calls(len(ids), dict(self_ns), dict(total_ns), {k: dict(v) for k, v in attrs.items()})


def per_call_ms(names: Sequence[str], own: bool = True) -> Optional[float]:
    """Mean per call of the spans ``names``: their self time (``own``) or whole duration, in ms."""
    c = calls()
    if c is None:
        return None
    times = c.self_ns if own else c.total_ns
    return sum(times.get(n, 0) for n in names) / c.n / 1e6


def attr_ratio(name: str, num: str, den: str) -> Optional[float]:
    """Sum of attribute ``num`` over the stretch's ``name`` spans over the sum of ``den``."""
    c = calls()
    if c is None:
        return None
    sums = c.attrs.get(name, {})
    return sums[num] / sums[den] if sums.get(den) else None
