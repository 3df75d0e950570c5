"""Fault-tolerant serving lifecycle: circuit breaking, heuristic fallback,
and shadow-evaluated bundle hot-swap with rollback.

The port of ``repro/serve/lifecycle.py``.  COSTREAM's deployment story
(PAPER.md §6) assumes the served cost model stays
healthy forever; this module is the failure path and the model-lifecycle path
the ROADMAP's "shadow evaluation before swap" item calls for (the Microsoft
"Learning, Retrofitting" playbook in PAPERS.md: never promote a retrained
model without validating it against live traffic first):

* ``CircuitBreaker`` — the classic closed -> open -> half-open state machine
  over a sliding window of per-request estimator outcomes.  While open,
  ``PlacementService`` answers score requests from ``fallback_scores``
  (tagged ``degraded`` in ``ServiceStats``) instead of failing clients, so
  the ``PlacementController`` keeps running on approximate costs during an
  estimator brown-out.
* ``fallback_scores`` — a deterministic heuristic stand-in for estimator
  scores, built on the in-tree ``heuristic_placement`` baseline: candidates
  are ranked by assignment distance to the heuristic placement (closer is
  better), feasibility filters answer optimistically.  Finite, cheap, and
  model-free — it works precisely when the model does not.
* ``BundleSwapper`` — shadow-evaluates a candidate ``CostModelBundle``
  against live traffic (mirroring a policy-configured fraction of drained
  score requests through the candidate off the critical path, scoring rank
  correlation on placement orderings + relative cost error vs the live
  answers), then promotes via ``PlacementService.swap_bundle`` or rejects
  with a typed ``ShadowRejected`` verdict; an optional post-promotion health
  window auto-rolls back on error-rate regression.

All thresholds live on ``DispatchPolicy`` (``shadow_*``, ``breaker_*``,
``health_*``; sizing rationale beside each field in serve/policy.py).  State
machines, failure taxonomy, and operational guidance: docs/robustness.md.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.model import CLASSIFICATION_METRICS
from repro_torch.placement.enumerate import heuristic_placement
from repro_torch.serve.policy import DispatchPolicy

__all__ = [
    "CircuitBreaker",
    "ShadowRejected",
    "ShadowVerdict",
    "BundleSwapper",
    "fallback_scores",
]


# -- circuit breaker --------------------------------------------------------------


class CircuitBreaker:
    """Failure-rate-windowed breaker over per-request estimator outcomes.

    States: **closed** (normal; every call allowed) -> **open** (the windowed
    failure rate crossed ``failure_rate`` with at least ``min_samples``
    outcomes; calls denied for ``cooldown_s``) -> **half-open** (cooldown
    expired; exactly ONE probe is allowed through) -> closed on probe success
    / re-open on probe failure.  Thread-safe; the service records outcomes
    from its worker thread and client threads may read ``state``.

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).  Thresholds come from the ``breaker_*`` fields of a
    ``DispatchPolicy`` via ``from_policy`` (docs/robustness.md#breaker).
    """

    def __init__(
        self,
        window: int = 16,
        failure_rate: float = 0.5,
        min_samples: int = 4,
        cooldown_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        if min_samples > window:
            raise ValueError(f"min_samples {min_samples} > window {window}")
        self.window = int(window)
        self.failure_rate = float(failure_rate)
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: "deque[bool]" = deque(maxlen=self.window)
        self._state = "closed"
        self._opened_at = 0.0
        self.n_opens = 0  # lifetime open transitions (observability)

    @classmethod
    def from_policy(
        cls, policy: DispatchPolicy, clock: Callable[[], float] = time.monotonic
    ) -> "CircuitBreaker":
        return cls(
            window=policy.breaker_window,
            failure_rate=policy.breaker_failure_rate,
            min_samples=policy.breaker_min_samples,
            cooldown_s=policy.breaker_cooldown_s,
            clock=clock,
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """Whether a real estimator call may proceed right now.

        Open + expired cooldown transitions to half-open and admits exactly
        one probe; every other open/half-open call is denied (the caller
        serves degraded answers instead)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = "half_open"
                    return True  # the single probe
                return False
            return False  # half_open: a probe is already in flight

    def record_success(self) -> None:
        with self._lock:
            self._outcomes.append(True)
            if self._state == "half_open":  # probe succeeded: recover
                self._state = "closed"
                self._outcomes.clear()

    def record_failure(self) -> None:
        with self._lock:
            self._outcomes.append(False)
            if self._state == "half_open":  # probe failed: back to open
                self._state = "open"
                self._opened_at = self._clock()
                self.n_opens += 1
                return
            if self._state == "closed" and len(self._outcomes) >= self.min_samples:
                failures = sum(1 for ok in self._outcomes if not ok)
                if failures / len(self._outcomes) >= self.failure_rate:
                    self._state = "open"
                    self._opened_at = self._clock()
                    self.n_opens += 1


# -- heuristic fallback scorer ----------------------------------------------------


def fallback_scores(
    query, cluster, assignments: np.ndarray, metrics: Sequence[str]
) -> Dict[str, np.ndarray]:
    """Model-free stand-in for ``CostEstimator.score`` during a brown-out.

    Ranks candidates by normalized assignment distance ``d`` to the
    deterministic ``heuristic_placement`` baseline (the paper's Exp-2a
    comparison placement): minimized regression metrics answer ``1 + d``,
    ``throughput`` (maximized) answers ``1 / (1 + d)``, and classification
    feasibility filters answer optimistically (1 = success / no
    backpressure — a brown-out must widen the candidate set, not empty it).
    Deterministic, finite, and cheap: one heuristic placement plus one
    vectorized distance per call, no model state touched.

    The answers are *approximate by construction*: they preserve only
    "prefer placements near the known-good heuristic", which is exactly the
    paper's pre-model baseline behavior.  ``ServiceStats.degraded`` tells
    consumers (e.g. the controller's degraded mode) they are looking at
    fallback numbers.
    """
    a = np.asarray(assignments, dtype=np.int64)
    if a.ndim != 2 or len(a) == 0:
        raise ValueError("no candidates to score")
    ref = np.asarray(heuristic_placement(query, cluster).assignment, dtype=np.int64)
    d = (a != ref[None, :]).mean(axis=1)  # (N,) in [0, 1]
    out: Dict[str, np.ndarray] = {}
    for m in metrics:
        if m in CLASSIFICATION_METRICS:
            out[m] = np.ones(len(a), dtype=np.float64)
        elif m == "throughput":
            out[m] = 1.0 / (1.0 + d)
        else:
            out[m] = 1.0 + d
    return out


# -- shadow evaluation ------------------------------------------------------------


def _avg_ranks(x: np.ndarray) -> np.ndarray:
    """Tie-averaged ordinal ranks, so constant runs carry no fake ordering."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(x.size, dtype=np.float64)
    sx = x[order]
    i = 0
    while i < x.size:
        j = i
        while j + 1 < x.size and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def _spearman(live: np.ndarray, shadow: np.ndarray) -> Optional[float]:
    """Spearman rank correlation of two score vectors (ordinal ranks).

    None when fewer than two candidates (no ordering to compare).  A
    constant vector has no ordering information: both constant -> 1.0
    (trivially agreeing), one constant -> 0.0.
    """
    live = np.asarray(live, dtype=np.float64)
    shadow = np.asarray(shadow, dtype=np.float64)
    if live.size < 2:
        return None
    ra = _avg_ranks(live)
    rb = _avg_ranks(shadow)
    sa, sb = ra - ra.mean(), rb - rb.mean()
    denom = float(np.sqrt((sa * sa).sum() * (sb * sb).sum()))
    if denom == 0.0:
        return 1.0 if bool(np.all(ra == rb)) else 0.0
    return float((sa * sb).sum() / denom)


@dataclass(frozen=True)
class ShadowVerdict:
    """The outcome of one shadow phase, with the evidence behind it.

    ``rank_corr`` is the mean Spearman correlation between live and candidate
    placement orderings over mirrored multi-candidate regression scores
    (None: no request carried an ordering); ``rel_err`` the mean relative
    cost error (classification metrics contribute their disagreement rate).
    ``thresholds`` records the policy values the verdict was judged against.
    """

    accepted: bool
    reason: str
    n_mirrored: int
    n_dropped: int
    n_candidate_errors: int
    rank_corr: Optional[float]
    rel_err: Optional[float]
    thresholds: Dict[str, float] = field(default_factory=dict)


class ShadowRejected(RuntimeError):
    """A candidate bundle failed shadow evaluation; ``.verdict`` has why."""

    def __init__(self, verdict: ShadowVerdict):
        super().__init__(f"candidate rejected by shadow evaluation: {verdict.reason}")
        self.verdict = verdict


class BundleSwapper:
    """Shadow-evaluate a candidate estimator against live traffic, then
    promote it into a running ``PlacementService`` — or reject it.

    Protocol (state machine in docs/robustness.md#swap)::

        swapper = BundleSwapper(service, seed=0)
        swapper.start_shadow(candidate)      # bundle or CostEstimator
        ... live traffic flows ...           # a fraction is mirrored
        swapper.drain_shadow()               # deterministic tests: flush
        verdict = swapper.promote()          # swap, or raise ShadowRejected

    The mirror is a service observer: after each drain finalizes, a seeded
    ``shadow_fraction`` sample of successfully-answered score requests is
    re-scored through the candidate on a dedicated shadow thread — off the
    critical path, bounded by ``shadow_queue_depth`` (when full, samples are
    dropped and counted: shadow evaluation sheds load, it never
    backpressures live traffic).  The shadow phase doubles as candidate
    warmup: every structure it scores has its skeleton cached before
    promotion.

    ``promote`` applies the swap at a drain boundary via
    ``service.swap_bundle`` and (by default) arms a post-promotion health
    window: after ``health_window_requests`` further drained requests, the
    incremental (degraded + non-finite + timed-out + failed) rate is
    compared against ``health_error_rate_max`` and the PREVIOUS estimator is
    swapped back in on regression (``rolled_back``/``rollback_reason``).
    """

    def __init__(self, service, seed: int = 0, policy: Optional[DispatchPolicy] = None):
        self.service = service
        self.policy = (policy if policy is not None else service.policy).validate()
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[Tuple]" = deque()
        self._pairs: List[Tuple[Dict, Dict, Tuple[str, ...]]] = []
        self._n_mirrored = 0
        self._n_dropped = 0
        self._n_candidate_errors = 0
        self._inflight = False
        self._stop = False
        self._mirroring = False
        self._candidate = None
        self._thread: Optional[threading.Thread] = None
        self._previous = None
        self._health: Optional[Dict] = None
        self.rolled_back = False
        self.rollback_reason: Optional[str] = None

    # -- shadow phase -------------------------------------------------------------

    def start_shadow(self, candidate) -> None:
        """Install the mirror and begin shadow-scoring through ``candidate``
        (a ``CostModelBundle`` — wrapped with the service's policy, on the
        live estimator's device — or a ready ``CostEstimator``).  Restartable: a second call after
        ``stop_shadow`` begins a fresh phase with fresh statistics."""
        from repro_torch.serve.estimator import CostEstimator

        if not isinstance(candidate, CostEstimator):
            candidate = CostEstimator.from_bundle(
                candidate, policy=self.service.policy, device=self.service.estimator.device
            )
        with self._lock:
            if self._mirroring:
                raise RuntimeError("a shadow phase is already running")
            self._candidate = candidate
            self._queue.clear()
            self._pairs = []
            self._n_mirrored = self._n_dropped = self._n_candidate_errors = 0
            self._stop = False
            self._mirroring = True
        self._thread = threading.Thread(
            target=self._shadow_loop, name="bundle-shadow", daemon=True
        )
        self._thread.start()
        self.service.add_observer(self._mirror)

    def _mirror(self, reqs, answers) -> None:
        # runs on the service worker thread after each finalized drain group:
        # sample delivered score answers into the bounded shadow queue
        for r, ans in zip(reqs, answers):
            if (
                r.kind != "score"
                or isinstance(ans, BaseException)
                or getattr(ans, "degraded", False)
            ):
                continue  # only mirror requests the live model truly answered
            with self._cond:
                if not self._mirroring or self._stop:
                    return
                if self._rng.random() >= self.policy.shadow_fraction:
                    continue
                if len(self._queue) >= self.policy.shadow_queue_depth:
                    self._n_dropped += 1  # shed, never backpressure
                    continue
                query, cluster, a, metrics, _ = r.payload
                self._queue.append((query, cluster, a, metrics, dict(ans)))
                self._cond.notify_all()

    def _shadow_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop and not self._queue:
                    return
                item = self._queue.popleft()
                self._inflight = True
            query, cluster, a, metrics, live = item
            shadow = None
            try:
                shadow = self._candidate.score(query, cluster, a, metrics)
            except Exception:
                pass  # counted below; a raising candidate is itself a verdict
            with self._cond:
                self._n_mirrored += 1
                if shadow is None:
                    self._n_candidate_errors += 1
                else:
                    self._pairs.append((live, dict(shadow), tuple(metrics)))
                self._inflight = False
                self._cond.notify_all()

    def drain_shadow(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued mirror sample is scored (tests/benches
        use this to make verdicts deterministic).  False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    def stop_shadow(self) -> None:
        """Uninstall the mirror and stop the shadow thread.  Mirrored
        statistics survive — ``verdict()`` stays valid after stopping."""
        try:
            self.service.remove_observer(self._mirror)
        except ValueError:
            pass
        with self._cond:
            self._stop = True
            self._mirroring = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- verdict + promotion ------------------------------------------------------

    def verdict(self) -> ShadowVerdict:
        """Judge the candidate on what the shadow phase observed so far."""
        with self._lock:
            pairs = list(self._pairs)
            n_m, n_d, n_err = self._n_mirrored, self._n_dropped, self._n_candidate_errors
        corrs: List[float] = []
        rels: List[float] = []
        for live, shadow, metrics in pairs:
            for m in metrics:
                l = np.asarray(live[m], dtype=np.float64)
                s = np.asarray(shadow[m], dtype=np.float64)
                if m in CLASSIFICATION_METRICS:
                    rels.extend(np.abs(s - l).tolist())  # disagreement rate
                    continue
                rels.extend((np.abs(s - l) / (np.abs(l) + 1e-6)).tolist())
                if l.size >= 2 and float(np.ptp(l)) > 0.0:
                    c = _spearman(l, s)
                    if c is not None:
                        corrs.append(c)
        rank_corr = float(np.mean(corrs)) if corrs else None
        rel_err = float(np.mean(rels)) if rels else None
        thresholds = {
            "shadow_min_requests": self.policy.shadow_min_requests,
            "shadow_rank_corr_min": self.policy.shadow_rank_corr_min,
            "shadow_rel_err_max": self.policy.shadow_rel_err_max,
        }

        def _v(accepted: bool, reason: str) -> ShadowVerdict:
            return ShadowVerdict(
                accepted=accepted,
                reason=reason,
                n_mirrored=n_m,
                n_dropped=n_d,
                n_candidate_errors=n_err,
                rank_corr=rank_corr,
                rel_err=rel_err,
                thresholds=thresholds,
            )

        if n_err:
            return _v(False, f"candidate estimator raised on {n_err} mirrored request(s)")
        if n_m < self.policy.shadow_min_requests:
            return _v(
                False,
                f"insufficient shadow traffic ({n_m} < "
                f"shadow_min_requests={self.policy.shadow_min_requests})",
            )
        if rel_err is not None and rel_err > self.policy.shadow_rel_err_max:
            return _v(
                False,
                f"relative cost error {rel_err:.3f} > "
                f"shadow_rel_err_max={self.policy.shadow_rel_err_max}",
            )
        if rank_corr is not None and rank_corr < self.policy.shadow_rank_corr_min:
            return _v(
                False,
                f"placement-ordering rank correlation {rank_corr:.3f} < "
                f"shadow_rank_corr_min={self.policy.shadow_rank_corr_min}",
            )
        return _v(True, f"accepted over {n_m} mirrored request(s)")

    def promote(self, health_window: bool = True) -> ShadowVerdict:
        """Judge the shadow phase; on acceptance, swap the candidate live.

        Rejection raises ``ShadowRejected`` (shadow stopped, nothing
        swapped).  Acceptance stops the mirror, applies the swap at a drain
        boundary (``service.swap_bundle``), keeps the previous estimator for
        rollback, and — with ``health_window`` — watches the next
        ``health_window_requests`` drained requests: an incremental error
        rate above ``health_error_rate_max`` swaps the previous estimator
        back in (``rolled_back``/``rollback_reason`` record it).
        """
        v = self.verdict()
        candidate = self._candidate
        self.stop_shadow()
        if not v.accepted:
            raise ShadowRejected(v)
        st = self.service.stats
        self._previous = self.service.swap_bundle(candidate, wait=True)
        if health_window:
            self.rolled_back = False
            self.rollback_reason = None
            self._health = {
                "seen": 0,
                "n_degraded": st.n_degraded,
                "n_nonfinite": st.n_nonfinite,
                "n_timeouts": st.n_timeouts,
                "n_failed": st.n_failed,
            }
            self.service.add_observer(self._health_obs)
        return v

    def _health_obs(self, reqs, answers) -> None:
        # worker-thread observer: one verdict after health_window_requests
        h = self._health
        if h is None:
            return
        h["seen"] += len(reqs)
        if h["seen"] < self.policy.health_window_requests:
            return
        st = self.service.stats
        errors = (
            (st.n_degraded - h["n_degraded"])
            + (st.n_nonfinite - h["n_nonfinite"])
            + (st.n_timeouts - h["n_timeouts"])
            + (st.n_failed - h["n_failed"])
        )
        rate = errors / max(h["seen"], 1)
        self._health = None
        try:
            self.service.remove_observer(self._health_obs)
        except ValueError:
            pass
        if rate > self.policy.health_error_rate_max:
            self.rolled_back = True
            self.rollback_reason = (
                f"post-promotion error rate {rate:.3f} > "
                f"health_error_rate_max={self.policy.health_error_rate_max} "
                f"over {h['seen']} request(s)"
            )
            # wait=False: this runs ON the worker thread — the swap applies
            # at the next drain boundary; blocking here would deadlock
            self.service.swap_bundle(self._previous, wait=False)

    def close(self) -> None:
        """Stop shadowing and disarm any pending health window."""
        self.stop_shadow()
        self._health = None
        try:
            self.service.remove_observer(self._health_obs)
        except ValueError:
            pass
