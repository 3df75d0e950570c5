"""Seeded, deterministic fault injection for the serving stack.

Production estimators fail in a handful of characteristic ways — a forward
raises (driver hiccup, OOM), a forward hangs (device contention), the model
emits NaN/Inf (bad bundle, out-of-distribution input), the bundle on disk is
corrupt (truncated upload), or the host is simply slow.  This module turns
each of those into an *injector* that installs via the estimator hook seam
(``CostEstimator.add_hook``) and misbehaves on a seeded schedule, so a chaos
run is exactly reproducible: same seed + same request order = same faults at
the same calls.

Injector protocol (duck-typed, matches the estimator's hook seam):

* ``before(kind, n)`` — called when a forward for ``kind`` (``"score"``,
  ``"estimate"``, ...) covering ``n`` rows is dispatched.  Raising here
  fails the forward before any device work.
* ``after(kind, out) -> out | None`` — called when the forward's results
  materialize at drain-finalize.  Returning a value replaces the output
  (how ``NaNFault`` poisons results); returning ``None`` keeps it.

Every injector has an ``enabled`` flag (flip it to open/close the fault
window without touching the hook list), an ``n_injected`` counter, and draws
from its own ``numpy`` Generator.  ``benchmarks/chaos_bench.py`` drives the
open-loop load harness under each profile; ``docs/robustness.md`` catalogs
the profiles and the budgets they are gated against.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Callable, Dict, Optional

import numpy as np


class ChaosError(RuntimeError):
    """An injected transient fault (retryable, unlike a typed verdict)."""


class _Injector:
    """Common machinery: seeded rng, enable window, injection counter."""

    def __init__(self, p: float = 1.0, seed: int = 0):
        assert 0.0 <= p <= 1.0, p
        self.p = p
        self.rng = np.random.default_rng(seed)
        self.enabled = True
        self.n_injected = 0

    def _fire(self) -> bool:
        # the rng is consumed even while disabled so the post-window draws
        # don't depend on how long the window was — the schedule stays a
        # pure function of (seed, call index)
        hit = self.rng.random() < self.p
        if not self.enabled:
            return False
        if hit:
            self.n_injected += 1
        return hit

    def before(self, kind: str, n: int) -> None:  # pragma: no cover - default
        pass

    def after(self, kind: str, out):  # pragma: no cover - default
        return None


class RaiseFault(_Injector):
    """Forward raises ``ChaosError`` at dispatch with probability ``p``."""

    def before(self, kind: str, n: int) -> None:
        if self._fire():
            raise ChaosError(f"injected raise on {kind} ({n} rows)")


class HangFault(_Injector):
    """Forward hangs for ``hang_s`` at dispatch with probability ``p``.

    The hang is a bounded sleep, not an unbounded block: the point is to
    push requests past their deadline / SLO budget deterministically, not to
    wedge the test process.
    """

    def __init__(self, hang_s: float = 0.2, p: float = 1.0, seed: int = 0):
        super().__init__(p=p, seed=seed)
        assert hang_s >= 0.0, hang_s
        self.hang_s = hang_s

    def before(self, kind: str, n: int) -> None:
        if self._fire():
            time.sleep(self.hang_s)


class NaNFault(_Injector):
    """Poison a forward's outputs with NaN with probability ``p``.

    Replaces the first value of every float metric in the result — the
    estimator's always-on finite guard then raises ``NonFiniteEstimate``,
    which is exactly the path a silently-garbage model exercises.  Outputs
    are copied, never mutated in place: the fault corrupts what this caller
    sees, not shared buffers.
    """

    def after(self, kind: str, out):
        if not self._fire():
            return None
        items = out if isinstance(out, (list, tuple)) else [out]
        poisoned = []
        for d in items:
            if d is None:
                poisoned.append(d)
                continue
            bad = {}
            for m, v in d.items():
                v = np.asarray(v)
                if v.dtype.kind == "f" and v.size:
                    v = v.copy()
                    v.flat[0] = np.nan
                bad[m] = v
            poisoned.append(bad)
        return poisoned if isinstance(out, (list, tuple)) else poisoned[0]


class SlowHost(_Injector):
    """Every forward pays an extra ``delay_s`` — a uniformly slow host.

    Unlike ``HangFault`` this is not probabilistic: slowness is a property
    of the host, not of individual calls, so ``p`` defaults to 1 and the
    delay applies to each dispatched forward while enabled.
    """

    def __init__(self, delay_s: float = 0.02, seed: int = 0):
        super().__init__(p=1.0, seed=seed)
        assert delay_s >= 0.0, delay_s
        self.delay_s = delay_s

    def before(self, kind: str, n: int) -> None:
        if self._fire():
            time.sleep(self.delay_s)


def corrupt_bundle(directory: str, seed: int = 0, n_bytes: int = 64) -> str:
    """Flip bytes inside the bundle's ``arrays.npz`` — a truncated/bit-rotted
    artifact on disk.  Returns the corrupted file's path.

    The corruption targets the newest step dir (the one ``load`` picks) and
    overwrites ``n_bytes`` seeded positions past the zip header, so
    ``CostModelBundle.load(verify=True)`` reliably rejects it while the
    file still *exists* and still looks like a bundle to a directory listing.
    """
    candidates = sorted(glob.glob(os.path.join(directory, "step_*", "arrays.npz")))
    if not candidates:
        raise FileNotFoundError(f"no step_*/arrays.npz under {directory}")
    path = candidates[-1]
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    # skip the first 512 bytes when the file allows: corrupting the member
    # payloads (not just the magic) exercises the per-metric verify path,
    # not only np.load's header check
    lo = min(512, max(0, size - n_bytes - 1))
    positions = rng.integers(lo, size, size=min(n_bytes, size))
    with open(path, "r+b") as f:
        for pos in positions:
            f.seek(int(pos))
            byte = f.read(1)
            f.seek(int(pos))
            f.write(bytes([byte[0] ^ 0xFF if byte else 0xFF]))
    return path


def profiles(seed: int = 0) -> Dict[str, Callable[[], Optional[_Injector]]]:
    """The chaos-profile catalog: name -> fresh-injector factory.

    Factories (not instances) so each benchmark phase gets an injector with
    a pristine rng — reusing one across phases would make the second phase's
    fault schedule depend on the first's call count.  ``corrupt_bundle`` is
    not listed: it is an on-disk fault, injected at load time, not a hook.
    """
    return {
        "raise": lambda: RaiseFault(p=0.3, seed=seed),
        "hang": lambda: HangFault(hang_s=0.08, p=0.3, seed=seed),
        "nan": lambda: NaNFault(p=0.4, seed=seed),
        "slow_host": lambda: SlowHost(delay_s=0.01, seed=seed),
    }
