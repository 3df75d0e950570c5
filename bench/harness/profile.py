"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

After ``chip_smoke.py``'s ``device_split`` (the device's busy time and idle share of a traced
stretch, from the profiler's device events), with two changes: busy time is the union of the
device's kernel, copy and set intervals inside the stretch (a sum would count overlapping streams
twice), and every idle gap is labelled by the benchmark's own host span that covered most of it.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

STRETCH = "bench.stretch"
SPANS = ("bench.dispatch", "bench.finalize")


@dataclass
class Trace:
    window_s: float  # the traced stretch, host span to host span
    busy_s: float  # union of device activity inside it
    ops: Dict[str, Tuple[int, float]]  # device op name -> (count, seconds)
    gaps: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)  # span -> (count, seconds, longest)
    calls: List[int] = field(default_factory=list)  # calls dispatched inside the stretch

    def kernel(self, name: str) -> Tuple[int, float]:
        """(launches, device seconds) of every device op whose name holds ``<name>_kernel``."""
        n, s = 0, 0.0
        for op, (c, sec) in self.ops.items():
            if f"{name}_kernel" in op:
                n, s = n + c, s + sec
        return n, s


def _is_device(e) -> bool:
    if str(e.device_type()).split(".")[-1] != "CUDA":
        return False
    # the device's copies of the benchmark's own spans are annotations, not work
    return not e.is_user_annotation() and not e.name().startswith("bench.")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(prof, calls: List[int]) -> Trace:
    events = prof.profiler.kineto_results.events()
    stretch = [e for e in events if e.name() == STRETCH and not _is_device(e)]
    if len(stretch) != 1:
        raise RuntimeError(f"the trace holds {len(stretch)} '{STRETCH}' host spans, want 1")
    t0, t1 = stretch[0].start_ns(), stretch[0].end_ns()
    dev, spans = [], []
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        if _is_device(e):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if b <= t0 or a >= t1:
                continue
            dev.append((max(a, t0), min(b, t1)))
            ops[e.name()][0] += 1
            ops[e.name()][1] += e.duration_ns() / 1e9
        elif e.name() in SPANS:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _union(dev)
    gaps: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            label, best = "bench.loop", 0
            for s, e, name in spans:
                over = min(b, e) - max(edge, s)
                if over > best:
                    label, best = name, over
            g = gaps[label]
            g[0] += 1
            g[1] += (a - edge) / 1e9
            g[2] = max(g[2], (a - edge) / 1e9)
        edge = max(edge, b)
    return Trace(
        window_s=(t1 - t0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        ops={k: (int(c), s) for k, (c, s) in ops.items()},
        gaps={k: (int(c), s, m) for k, (c, s, m) in gaps.items()},
        calls=list(calls),
    )


NAME_CHARS = 200  # device op names are cut here: a templated kernel's full name runs to 1,000 characters


def breakdown(trace: Trace) -> dict:
    """The result line's ``breakdown``: the 10 costliest device ops and the idle time by host span."""
    top = sorted(trace.ops.items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "device_ops": [[name[:NAME_CHARS], sec] for name, (_, sec) in top],
        "idle_gaps": [[f"{name} ({n} gaps, longest {longest} s)", sec] for name, (n, sec, longest) in gaps],
    }
