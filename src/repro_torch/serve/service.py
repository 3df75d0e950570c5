"""``PlacementService``: a micro-batching front-end over a ``CostEstimator``.

The port of ``repro/serve/service.py``.  The paper deploys COSTREAM by
running "parallel instances" to score candidate placements concurrently
(§V); on a card the analogue is not N processes but ONE fused forward whose
batch axis carries every concurrent request.  This service is that serving
layer: requests are submitted from any thread and answered with futures,
while a single worker thread drains everything queued at each wake-up —
adaptive micro-batching, so while one fused forward runs, new requests pile
up and form the next batch — and answers each compatible group with one
stacked forward through the shared estimator:

* ``score`` requests coalesce per metrics tuple — including requests for
  *different* (query, cluster) structures: their placement batches merge
  structure-major into ONE shared batch (``CostEstimator.score_many``)
  answered by a single signature-banded merged forward per ``max_batch``
  chunk.  Merging trades S-1 dispatches for span-conservative stage work, so
  the drain routes adaptively: dispatch-bound drains (at most
  ``cross_query_row_limit`` candidate rows per structure on average) merge,
  compute-bound drains — and single-structure groups — take the
  placement-specialized per-structure path, which wins its dispatch back in
  exact per-query stage-3 work.  ``cross_query=False`` pins the pre-merge
  behavior of one forward per structure.  Scores are batchmate-independent,
  so coalescing is invisible to callers;
* ``estimate`` requests coalesce per metrics tuple: every ``JointGraph``
  shares the same padded layout, so batches concatenate along the batch axis
  (``CostEstimator.estimate_many``).

Latency engineering:

* **double-buffered drains** (``double_buffer``, default on for a CUDA
  estimator): every drain is split into a *launch* half (host-side grouping +
  featurization + device dispatch, via the estimator's ``deferred=True``
  calls) and a *finalize* half (copy the device values back, vote, resolve
  futures).  The worker launches drain N+1 before finalizing drain N; the
  launch half waits for nothing on the host (its copies are asynchronous
  from page-locked memory), so host featurization overlaps device compute
  and the steady-state drain cycle tracks ``max(host, device)`` instead of
  their sum;
* **bounded-queue admission control** (``max_queue_depth``): past the bound,
  ``submit_*`` raises ``ServiceOverloadError`` (``overflow="reject"``) or
  blocks the producer (``overflow="block"``) instead of queueing unbounded
  work;
* **warm structures** (``warmup=[(query, cluster), ...]``): ``start()``
  runs every bucket-padded forward shape the structure set can hit before
  the first request, so the kernels' first-use build, the BLAS handle and
  the allocator's first blocks never land in a caller's latency.  The
  service only merges structure mixes that are warmed or within
  ``max_merged_mixes`` first-seen runtime admissions, and routes every other
  drain down the per-structure path — the JAX package's rule, which keeps
  this port's routing and counters equal to it.

The worker is one Python thread that runs under ``torch.no_grad()`` on the
current CUDA stream; client threads touch only futures and numpy answers.
Every ``Exception`` from the estimator other than the typed verdicts counts
as transient and is retried, a CUDA error included: a sticky CUDA error then
fails every later attempt and keeps the breaker open until restart.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bucketing import bucket_size
from repro_torch.core.graph import JointGraph, skeleton_cache_key
from repro_torch.serve.estimator import CostEstimator, NonFiniteEstimate
from repro_torch.serve.lifecycle import CircuitBreaker, fallback_scores
from repro_torch.serve.policy import DispatchPolicy

# distinguishes "argument not passed" (fall back to the policy) from an
# explicit None, which several knobs accept with meaning (e.g.
# cross_query_row_limit=None -> always merge)
_UNSET = object()


class ServiceOverloadError(RuntimeError):
    """A submit hit the bounded queue (``max_queue_depth``) with
    ``overflow="reject"``: the request was *not* enqueued.  Callers shed load
    (drop, retry with backoff, or degrade) instead of growing tail latency."""


class EstimateTimeoutError(TimeoutError):
    """A request's ``deadline_s`` expired before its drain finalized.

    Enforced at drain-finalize: the answer (even a computed one) is replaced
    by this error, because a placement decision made on a stale cost estimate
    is worse than an honest timeout the caller can fall back from.  Counted
    in ``ServiceStats.n_timeouts`` and fed to the circuit breaker (a
    browning-out estimator times out before it fails)."""


class _Degraded(dict):
    """A score answer computed by the heuristic fallback scorer, not the
    model.  A plain mapping to callers (same metric -> array shape), plus a
    ``degraded`` marker and the estimator failure that caused it (None when
    the breaker was already open and the estimator was never tried)."""

    degraded = True

    def __init__(self, values: Dict, cause: Optional[BaseException] = None):
        super().__init__(values)
        self.cause = cause


@dataclass
class ServiceStats:
    """Worker-side counters (mutated under the service lock).

    ``n_drained`` is the sum of all drain sizes, so ``n_drained ==
    n_requests`` exactly when every submitted request has been popped by the
    worker (the service-parity property tests pin this).  ``queue_wait_s`` /
    ``max_queue_wait_s`` measure time between submit and drain pop —
    time-in-queue, the component of request latency that backpressure and
    double-buffering exist to bound.
    """

    n_requests: int = 0
    n_batches: int = 0  # worker wake-ups that executed work
    n_forwards: int = 0  # estimator calls issued (one per group chunk)
    n_coalesced: int = 0  # requests that shared a forward with another
    n_cross_query: int = 0  # score requests answered via a merged cross-query batch
    n_drained: int = 0  # requests popped into drains (== sum of drain sizes)
    n_rejected: int = 0  # submits refused by admission control (never enqueued)
    max_queue_depth: int = 0  # peak queued requests observed at submit
    max_drain: int = 0  # largest single drain
    queue_wait_s: float = 0.0  # total submit -> drain-pop time across requests
    max_queue_wait_s: float = 0.0  # worst single request's time in queue
    # -- robustness counters (docs/robustness.md) --------------------------------
    n_degraded: int = 0  # score answers served by the heuristic fallback scorer
    n_nonfinite: int = 0  # estimator outputs rejected by the NaN/Inf guard
    n_timeouts: int = 0  # answers replaced by EstimateTimeoutError at finalize
    n_retries: int = 0  # estimator re-attempts after a transient failure
    n_failed: int = 0  # requests delivered an exception (excl. bad requests)
    n_swaps: int = 0  # bundle swaps applied (incl. rollbacks)
    degraded: bool = False  # breaker not closed: answers may be fallback-based

    def reset(self) -> None:
        self.n_requests = self.n_batches = 0
        self.n_forwards = self.n_coalesced = self.n_cross_query = 0
        self.n_drained = self.n_rejected = 0
        self.max_queue_depth = self.max_drain = 0
        self.queue_wait_s = self.max_queue_wait_s = 0.0
        self.n_degraded = self.n_nonfinite = self.n_timeouts = 0
        self.n_retries = self.n_failed = self.n_swaps = 0
        self.degraded = False


class _Request(NamedTuple):
    kind: str  # "score" | "estimate"
    key: Tuple  # coalescing key: equal keys share one forward
    payload: Tuple
    future: Future
    t_submit: float  # monotonic enqueue time (time-in-queue tracking)
    deadline_s: Optional[float] = None  # answer-by budget from submit time


class _LaunchedGroup(NamedTuple):
    """One coalescing group whose device work is dispatched but not resolved.

    ``finalize`` blocks on the device values and returns ``(answers,
    n_forwards, n_cross)`` — the per-request answers (values or exceptions)
    plus the work counters recorded at launch."""

    reqs: List[_Request]
    finalize: Callable[[], Tuple[List[object], int, int]]


class PlacementService:
    """Coalesces concurrent estimate/score requests into fused forwards.

    ``max_batch`` bounds the candidate rows (score) / graphs (estimate) per
    fused forward — a group beyond it is scored in chunks.  ``cross_query``
    (default True) lets score requests for *different* query structures share
    one merged forward (``CostEstimator.score_many``); False restores the
    one-forward-per-structure drain.  Merging trades one dispatch for span-
    conservative stage work, so it pays exactly when drains are
    dispatch-bound: a drain averaging more than ``cross_query_row_limit``
    candidate rows per structure has enough work per structure to amortize
    its own specialized forward and takes the per-structure path instead
    (None: always merge).  The service merges only structure mixes
    registered by ``warm()`` plus at most ``max_merged_mixes`` first-seen
    runtime mixes (None: unbounded) — everything else takes the per-structure
    path, which bounds the estimator's merged-group cache under open-loop
    arrivals.

    ``max_queue_depth`` bounds the submit queue: past it, ``submit_*``
    raises ``ServiceOverloadError`` (``overflow="reject"``, the default) or
    blocks the producer until the worker drains (``overflow="block"``).
    ``double_buffer`` overlaps drain N+1's host featurization with drain N's
    device compute; the default (``None``) enables it only for a CUDA
    estimator — on the CPU host and "device" share cores, so the
    launch/finalize split buys no overlap and only fragments bursts into
    smaller drains.  ``warmup`` is an optional sequence of ``(query,
    cluster)`` structures run by ``start()`` (see ``warm()``), so p99 never
    pays first-use setup.

    ``auto_start`` False leaves the worker stopped so tests (and one-shot
    batch jobs) can enqueue everything first and then ``start()`` for one
    deterministic drain.  Use as a context manager or call ``close()`` to
    stop the worker; close drains (or fails — never silently drops) every
    accepted request.

    Every dispatch default (``max_batch``, ``cross_query_row_limit``,
    ``double_buffer``, ``warmup_cands``, ``max_merged_mixes``) comes from the
    service's ``DispatchPolicy`` — ``policy=`` if given, else the estimator's
    resolved policy (host profile / ``REPRO_DISPATCH_PROFILE`` / defaults;
    see serve/policy.py).  An explicit constructor argument always wins over
    the policy, including explicit ``None`` where that is meaningful
    (``cross_query_row_limit=None`` means *always merge*).
    """

    def __init__(
        self,
        estimator: CostEstimator,
        max_batch: Optional[int] = None,
        auto_start: bool = True,
        cross_query: bool = True,
        cross_query_row_limit=_UNSET,
        max_queue_depth: Optional[int] = None,
        overflow: str = "reject",
        double_buffer=_UNSET,
        warmup: Optional[Sequence[Tuple]] = None,
        warmup_cands: Optional[int] = None,
        max_merged_mixes=_UNSET,
        policy: Optional[DispatchPolicy] = None,
        seed: int = 0,
    ):
        if overflow not in ("reject", "block"):
            raise ValueError(f"overflow must be 'reject' or 'block', got {overflow!r}")
        self.estimator = estimator
        self.policy = (policy if policy is not None else estimator.policy).validate()
        self.max_batch = int(max_batch if max_batch is not None else self.policy.max_batch)
        self.cross_query = bool(cross_query)
        self.cross_query_row_limit = (
            self.policy.cross_query_row_limit
            if cross_query_row_limit is _UNSET
            else cross_query_row_limit
        )
        self.max_queue_depth = max_queue_depth
        self.overflow = overflow
        if double_buffer is _UNSET or double_buffer is None:
            # launch-ahead only pays where device compute runs beside the
            # host; on the CPU they share cores, so the split just fragments
            # drains; the policy's tri-state None applies the device rule
            double_buffer = self.policy.resolved_double_buffer(estimator.device)
        self.double_buffer = bool(double_buffer)
        self.warmup_cands = int(
            warmup_cands if warmup_cands is not None else self.policy.warmup_cands
        )
        self.max_merged_mixes = (
            self.policy.max_merged_mixes if max_merged_mixes is _UNSET else max_merged_mixes
        )
        self.stats = ServiceStats()
        self._warmup = list(warmup) if warmup else []
        self._warmed = False
        # structure mixes allowed on the merged path: warmed mixes plus up to
        # max_merged_mixes first-seen runtime mixes (insertion-ordered set)
        self._known_mixes: "OrderedDict[frozenset, bool]" = OrderedDict()
        self._n_runtime_mixes = 0
        self._queue: "deque[_Request]" = deque()
        self._cond = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # -- robustness plumbing (docs/robustness.md) ----------------------------
        # seeded rng for retry backoff jitter; touched only by the worker
        self._rng = np.random.default_rng(seed)
        self._retry = self.policy.retry_policy()
        self._breaker = CircuitBreaker.from_policy(self.policy)
        # a requested estimator swap awaiting the next drain boundary:
        # (new estimator, future resolving to the replaced estimator)
        self._pending_swap: Optional[Tuple[CostEstimator, Future]] = None
        # observers fire on the worker thread after each finalized group
        # (the BundleSwapper mirror and health window ride this seam)
        self._observers: List[Callable] = []
        if auto_start:
            self.start()

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> "PlacementService":
        with self._cond:
            if self._stopped:  # not assert: a submit after close() must fail
                raise RuntimeError("PlacementService is closed")
            starting = self._thread is None
        if starting and self._warmup and not self._warmed:
            # outside the lock: warmup may take seconds, submits must not
            # block on it (they queue; the worker starts only after warm)
            self.warm(self._warmup, max_cands=self.warmup_cands)
        with self._cond:
            if self._stopped:
                raise RuntimeError("PlacementService is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="placement-service", daemon=True
                )
                self._thread.start()
        return self

    def close(self) -> None:
        """Stop the worker after draining everything already queued.

        Every accepted request resolves: queued futures on a never-started
        service fail with ``RuntimeError`` instead of leaving their waiters
        hanging, and if the worker thread died, requests it left behind are
        failed here rather than silently dropped."""
        with self._cond:
            self._stopped = True
            orphans = list(self._queue) if self._thread is None else []
            if orphans:
                self._queue.clear()
            self._cond.notify_all()
        for r in orphans:
            r.future.set_exception(RuntimeError("PlacementService closed before start"))
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            # a healthy worker exits only once the queue is empty; anything
            # left means it died mid-run — fail, never strand, the waiters
            with self._cond:
                leftovers = list(self._queue)
                self._queue.clear()
            for r in leftovers:
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError("PlacementService worker died before serving this request")
                    )
        # a swap the worker never applied resolves with an error — the
        # requester must not hang on a future nobody will fulfill
        with self._cond:
            swap, self._pending_swap = self._pending_swap, None
        if swap is not None and not swap[1].done():
            swap[1].set_exception(RuntimeError("PlacementService closed before the swap applied"))

    def __enter__(self) -> "PlacementService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- bundle hot-swap + observation (docs/robustness.md) -----------------------

    @property
    def breaker(self) -> CircuitBreaker:
        """The service's circuit breaker (read ``.state`` for health checks)."""
        return self._breaker

    def swap_bundle(self, candidate, wait: bool = True, timeout: Optional[float] = None):
        """Atomically replace the serving estimator at the next drain boundary.

        ``candidate`` is a ``CostEstimator`` or a ``CostModelBundle`` (wrapped
        with this service's policy, on the live estimator's device).  The swap quiesces between drains: groups
        already launched hold the old estimator in their finalize closures and
        finish on it; everything popped after the boundary routes to the new
        one; the old estimator's instance caches are released when its last
        in-flight group resolves.  Warm merged-mix admissions survive the swap
        (they key on structures, not weights).

        ``wait=True`` blocks until the boundary and returns the *replaced*
        estimator (rollback keeps it alive); ``wait=False`` returns a
        ``Future`` resolving to it — required when calling from a worker-side
        observer (the rollback path), where blocking would deadlock the very
        thread that applies swaps.  On a service whose worker is not running,
        the swap applies immediately.  Raises ``RuntimeError`` on a closed
        service or when another swap is still pending.
        """
        est = (
            candidate
            if isinstance(candidate, CostEstimator)
            else CostEstimator.from_bundle(candidate, policy=self.policy, device=self.estimator.device)
        )
        fut: Future = Future()
        with self._cond:
            if self._stopped:
                raise RuntimeError("PlacementService is closed")
            if self._pending_swap is not None:
                raise RuntimeError("a bundle swap is already pending")
            if self._thread is None:
                # no worker: there is no in-flight work to quiesce around
                old, self.estimator = self.estimator, est
                self.stats.n_swaps += 1
                fut.set_result(old)
                return fut.result() if wait else fut
            self._pending_swap = (est, fut)
            self._cond.notify_all()
        return fut.result(timeout) if wait else fut

    def add_observer(self, fn: Callable) -> None:
        """Register ``fn(requests, answers)``, called on the worker thread
        after each drain group's futures resolve (answers may be exceptions
        or ``degraded``-marked fallback dicts).  Observer errors are
        swallowed — observation must never fail a drain."""
        with self._cond:
            self._observers.append(fn)

    def remove_observer(self, fn: Callable) -> None:
        """Unregister an observer; raises ``ValueError`` if absent."""
        with self._cond:
            self._observers.remove(fn)

    # -- warmup -------------------------------------------------------------------

    def warm(
        self,
        structures: Sequence[Tuple],
        max_cands: Optional[int] = None,
        metrics: Optional[Sequence[str]] = None,
    ) -> int:
        """Run the bounded set of serving forwards for ``structures``.

        For each ``(query, cluster)`` pair, runs the placement-specialized
        scorer at every power-of-two candidate bucket up to
        ``bucket_size(max_cands)`` — every shape the per-structure drain path
        can hit — which caches the skeletons, builds the kernels at first
        use and warms the allocator.  When cross-query merging applies,
        additionally registers the full structure mix in the merged-mix set
        and runs the merged drain at every row bucket up to
        ``bucket_size(len(structures) * max_cands)`` (capped by
        ``max_batch``).  Dummy all-zero assignments are used — the work
        depends on shapes and structure, never on values.  Returns the number
        of warm forwards issued; the count is bounded by ``O(len(structures)
        * log(max_cands))``, never by traffic.
        """
        structures = list(structures)
        metrics = tuple(metrics) if metrics is not None else tuple(self.estimator.models)
        max_cands = self.warmup_cands if max_cands is None else int(max_cands)
        n_forwards = 0
        for q, c in structures:
            a1 = np.zeros((1, q.n_ops()), dtype=np.int64)
            b = 1
            while True:
                self.estimator.score(q, c, np.repeat(a1, b, axis=0), metrics)
                n_forwards += 1
                if b >= min(bucket_size(max_cands), self.max_batch):
                    break
                b *= 2
        if (
            self.cross_query
            and len(structures) > 1
            and self.estimator.supports_cross_query(metrics)
        ):
            mix = frozenset(skeleton_cache_key(q, c) for q, c in structures)
            with self._cond:
                self._known_mixes[mix] = True
            n_structures = len(structures)
            top = min(bucket_size(n_structures * max_cands), self.max_batch)
            b = bucket_size(n_structures)
            while True:
                # exactly b total rows distributed over every structure, so
                # the merged chunk pads to exactly this power-of-two bucket
                base, extra = divmod(b, n_structures)
                items = [
                    (q, c, np.zeros((base + (1 if j < extra else 0), q.n_ops()), dtype=np.int64))
                    for j, (q, c) in enumerate(structures)
                ]
                self.estimator.score_many(items, metrics, max_rows=self.max_batch)
                n_forwards += 1
                if b >= top:
                    break
                b *= 2
        self._warmed = True
        return n_forwards

    def _admit_mix(self, mix: frozenset) -> bool:
        """Whether this drain's structure mix may use the merged path.

        Warmed mixes always pass; unseen runtime mixes are admitted
        first-come up to ``max_merged_mixes`` (each admission buys a merged
        group — a device skeleton stack and its banding — so the bound keeps
        that cache finite under arbitrary arrival interleavings)."""
        if self.max_merged_mixes is None:
            return True
        with self._cond:
            if mix in self._known_mixes:
                return True
            if self._n_runtime_mixes >= self.max_merged_mixes:
                return False
            self._n_runtime_mixes += 1
            self._known_mixes[mix] = True
            return True

    # -- submission ---------------------------------------------------------------

    def _submit(self, req: _Request) -> Future:
        with self._cond:
            if self._stopped:  # not assert: under -O the future would hang forever
                raise RuntimeError("PlacementService is closed")
            if self.max_queue_depth is not None and len(self._queue) >= self.max_queue_depth:
                if self.overflow == "reject":
                    self.stats.n_rejected += 1
                    raise ServiceOverloadError(
                        f"queue depth {len(self._queue)} at max_queue_depth="
                        f"{self.max_queue_depth}; request rejected"
                    )
                while len(self._queue) >= self.max_queue_depth and not self._stopped:
                    self._cond.wait()
                if self._stopped:
                    raise RuntimeError("PlacementService is closed")
            self._queue.append(req)
            self.stats.n_requests += 1
            if len(self._queue) > self.stats.max_queue_depth:
                self.stats.max_queue_depth = len(self._queue)
            self._cond.notify_all()
        return req.future

    def _resolve_metrics(self, metrics: Optional[Sequence[str]]) -> Tuple[str, ...]:
        return tuple(metrics) if metrics is not None else tuple(self.estimator.models)

    @staticmethod
    def _check_deadline(deadline_s: Optional[float]) -> Optional[float]:
        if deadline_s is None:
            return None
        deadline_s = float(deadline_s)
        if not deadline_s > 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        return deadline_s

    def submit_score(
        self,
        query,
        cluster,
        assignments: np.ndarray,
        metrics: Optional[Sequence[str]] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Async ``CostEstimator.score``; resolves to metric -> (N,) scores.

        Raises ``ServiceOverloadError`` (or blocks, per ``overflow``) when
        the bounded queue is full.  ``deadline_s`` is an answer-by budget
        from submit time, enforced at drain-finalize: a late answer is
        replaced by ``EstimateTimeoutError`` (docs/robustness.md#deadlines)."""
        metrics = self._resolve_metrics(metrics)
        a = np.asarray(assignments, dtype=np.int64)
        skel_key = skeleton_cache_key(query, cluster)
        # cross-query services group on metrics alone — distinct structures
        # merge at drain time; the structure key rides along for sub-routing
        key = ("score", metrics) if self.cross_query else ("score", skel_key, metrics)
        return self._submit(
            _Request(
                "score", key, (query, cluster, a, metrics, skel_key), Future(),
                time.monotonic(), self._check_deadline(deadline_s),
            )
        )

    def submit_estimate(
        self,
        graphs: JointGraph,
        metrics: Optional[Sequence[str]] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Async ``CostEstimator.estimate`` over a batched ``JointGraph``.

        Raises ``ServiceOverloadError`` (or blocks, per ``overflow``) when
        the bounded queue is full.  ``deadline_s`` as in ``submit_score``."""
        metrics = self._resolve_metrics(metrics)
        # host numpy, featurized if traces, a single graph promoted to a batch of one
        graphs = self.estimator._host_graphs(graphs)
        key = ("estimate", metrics)
        return self._submit(
            _Request(
                "estimate", key, (graphs, metrics), Future(), time.monotonic(),
                self._check_deadline(deadline_s),
            )
        )

    def score(self, query, cluster, assignments, metrics=None) -> Dict[str, np.ndarray]:
        """Synchronous convenience: submit one score request and wait."""
        return self.submit_score(query, cluster, assignments, metrics).result()

    def estimate(self, graphs, metrics=None) -> Dict[str, np.ndarray]:
        """Synchronous convenience: submit one estimate request and wait."""
        return self.submit_estimate(graphs, metrics).result()

    # -- worker -------------------------------------------------------------------

    def _run(self) -> None:
        # The drain pipeline.  Each iteration pops everything queued, LAUNCHES
        # it (host grouping + featurization + async device dispatch), then
        # finalizes the PREVIOUS drain (block on device values, resolve
        # futures).  While drain N's device work runs, drain N+1's host work
        # proceeds — and when the queue is empty, the pending drain finalizes
        # immediately (the wait guard skips sleeping while work is in flight),
        # so idle-period latency never waits for a successor drain.
        pending: List[_LaunchedGroup] = []
        batch: List[_Request] = []
        launched: List[_LaunchedGroup] = []
        no_grad = torch.no_grad()  # grad mode is per thread: this one serves only
        no_grad.__enter__()
        try:
            while True:
                with self._cond:
                    while (
                        not self._queue
                        and not self._stopped
                        and not pending
                        and self._pending_swap is None
                    ):
                        self._cond.wait()
                    # the drain boundary: an estimator swap applies here —
                    # groups in `pending` hold the OLD estimator in their
                    # finalize closures and finish on it; everything popped
                    # from now on routes to the new one
                    swap, self._pending_swap = self._pending_swap, None
                    old_est = None
                    if swap is not None:
                        old_est, self.estimator = self.estimator, swap[0]
                        self.stats.n_swaps += 1
                    batch = list(self._queue)
                    self._queue.clear()
                    stopped = self._stopped
                    if batch:
                        now = time.monotonic()
                        self.stats.n_batches += 1
                        self.stats.n_drained += len(batch)
                        if len(batch) > self.stats.max_drain:
                            self.stats.max_drain = len(batch)
                        for r in batch:
                            wait = now - r.t_submit
                            self.stats.queue_wait_s += wait
                            if wait > self.stats.max_queue_wait_s:
                                self.stats.max_queue_wait_s = wait
                        self._cond.notify_all()  # blocked submitters: depth dropped
                if swap is not None:
                    # resolve outside the lock: done-callbacks run inline
                    swap[1].set_result(old_est)
                launched = []
                if batch:
                    groups: Dict[Tuple, List[_Request]] = {}  # dicts keep insertion order
                    for req in batch:
                        groups.setdefault(req.key, []).append(req)
                    for reqs in groups.values():
                        launched.append(self._launch_group(reqs))
                for lg in pending:
                    self._finalize_group(lg)
                if self.double_buffer:
                    pending = launched
                else:
                    for lg in launched:
                        self._finalize_group(lg)
                    pending = []
                batch, launched = [], []
                if stopped and not pending:
                    with self._cond:
                        if not self._queue and self._pending_swap is None:
                            return  # stopped and drained
        except BaseException as e:  # pragma: no cover - worker skeleton bug
            # group-level failures are delivered per future and never reach
            # here; this is the backstop for a bug in the loop itself: fail
            # everything this worker owes so no accepted request is dropped
            for lg in list(pending) + list(launched):
                for r in lg.reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            with self._cond:
                leftovers = list(self._queue)
                self._queue.clear()
                swap, self._pending_swap = self._pending_swap, None
                self._cond.notify_all()
            for r in leftovers:
                if not r.future.done():
                    r.future.set_exception(e)
            if swap is not None and not swap[1].done():
                swap[1].set_exception(e)
            raise
        finally:
            no_grad.__exit__(None, None, None)

    def _launch_group(self, reqs: List[_Request]) -> _LaunchedGroup:
        """Host-side half of one group: featurize + dispatch, don't wait."""
        try:
            if reqs[0].kind == "score":
                finalize = self._launch_scores(reqs)
            else:
                finalize = self._launch_estimates(reqs)
        except BaseException as e:  # launch failed: the whole group shares the error
            finalize = (lambda err: lambda: ([err] * len(reqs), 0, 0))(e)
        return _LaunchedGroup(reqs, finalize)

    def _finalize_group(self, lg: _LaunchedGroup) -> None:
        """Device-side half: read results back, record work, resolve futures."""
        try:
            answers, n_forwards, n_cross = lg.finalize()
        except BaseException as e:  # deliver, don't kill the worker
            answers, n_forwards, n_cross = [e] * len(lg.reqs), 0, 0
        answers = list(answers)
        # deadlines are judged where the answer materializes: an estimate
        # that finished after the caller's budget is replaced, not delivered
        now = time.monotonic()
        for j, r in enumerate(lg.reqs):
            if r.deadline_s is not None and (now - r.t_submit) > r.deadline_s:
                answers[j] = EstimateTimeoutError(
                    f"{r.kind} answered in {now - r.t_submit:.3f}s, "
                    f"over its {r.deadline_s:.3f}s deadline"
                )
        # count the work before resolving futures, so a caller woken by
        # result() never observes counters lagging its own answer
        with self._cond:
            self.stats.n_forwards += n_forwards
            self.stats.n_cross_query += n_cross
            if len(lg.reqs) > 1:
                self.stats.n_coalesced += len(lg.reqs)
            for answer in answers:
                if isinstance(answer, _Degraded):
                    self.stats.n_degraded += 1
                    if isinstance(answer.cause, NonFiniteEstimate):
                        self.stats.n_nonfinite += 1
                    if answer.cause is not None:
                        # a real estimator failure behind the fallback; a
                        # causeless _Degraded is the breaker's own
                        # short-circuit and must not re-feed it
                        self._breaker.record_failure()
                elif isinstance(answer, EstimateTimeoutError):
                    self.stats.n_timeouts += 1
                    self._breaker.record_failure()
                elif isinstance(answer, NonFiniteEstimate):
                    self.stats.n_nonfinite += 1
                    self.stats.n_failed += 1
                    self._breaker.record_failure()
                elif isinstance(answer, ValueError):
                    pass  # caller error, says nothing about estimator health
                elif isinstance(answer, BaseException):
                    self.stats.n_failed += 1
                    self._breaker.record_failure()
                else:
                    self._breaker.record_success()
            self.stats.degraded = self._breaker.state != "closed"
        # a per-request answer may be an exception (bad request, failed
        # subgroup): metrics-tuple groups span unrelated callers, so one
        # request's failure must never fail its batchmates
        for r, answer in zip(lg.reqs, answers):
            if isinstance(answer, BaseException):
                r.future.set_exception(answer)
            else:
                r.future.set_result(answer)
        for obs in list(self._observers):
            try:
                obs(lg.reqs, answers)
            except Exception:
                pass  # observers are best-effort, never worker-fatal

    def _launch_scores(self, reqs: List[_Request]) -> Callable:
        metrics = reqs[0].payload[3]
        answers: List[object] = [None] * len(reqs)
        # bad requests fail individually, they never poison the drain
        live = []
        for i, r in enumerate(reqs):
            if len(r.payload[2]) == 0:
                answers[i] = ValueError("no candidates to score")
            else:
                live.append(i)
        if live and not self._breaker.allow():
            # circuit open: serve heuristic-placement fallback scores without
            # touching the estimator at all; answers are tagged degraded so
            # callers (and ServiceStats) can tell

            def finalize():
                for i in live:
                    q, c, a, ms, _ = reqs[i].payload
                    answers[i] = self._degraded_answer(q, c, a, ms, cause=None)
                return answers, 0, 0

            return finalize

        distinct = {reqs[i].payload[4] for i in live}
        rows_per_structure = (
            sum(len(reqs[i].payload[2]) for i in live) / len(distinct) if live else 0.0
        )
        if (
            self.cross_query
            and len(distinct) > 1
            and (
                self.cross_query_row_limit is None
                or rows_per_structure <= self.cross_query_row_limit
            )
            and self.estimator.supports_cross_query(metrics)
            and self._admit_mix(frozenset(distinct))
        ):
            # the cross-query hot path: merge every structure's placement
            # batch and answer the whole drain with one signature-banded
            # merged forward per max_batch rows
            items = [(reqs[i].payload[0], reqs[i].payload[1], reqs[i].payload[2]) for i in live]
            pending = self.estimator.score_many(
                items,
                metrics,
                max_rows=self.max_batch,
                keys=[reqs[i].payload[4] for i in live],  # computed once at submit
                deferred=True,
            )
            total = sum(len(a) for _, _, a in items)
            n_forwards = -(-total // self.max_batch)
            n_cross = len(live)

            est = self.estimator  # finalize must use the estimator that launched

            def finalize():
                try:
                    results = pending.result()
                except BaseException as e:
                    try:
                        results = self._retry_call(
                            lambda: est.score_many(
                                items,
                                metrics,
                                max_rows=self.max_batch,
                                keys=[reqs[i].payload[4] for i in live],
                            ),
                            e,
                        )
                    except BaseException as final:
                        for i in live:
                            q, c, a, ms, _ = reqs[i].payload
                            answers[i] = self._degraded_answer(q, c, a, ms, cause=final)
                        return answers, n_forwards, n_cross
                for i, ans in zip(live, results):
                    answers[i] = ans
                return answers, n_forwards, n_cross

            return finalize

        # one structure (or merging unsupported / compute-bound / mix not
        # admitted): the placement-specialized per-structure path, candidate
        # matrices concatenated per skeleton; a failing subgroup fails only
        # its own requests
        subgroups: Dict[Tuple, List[int]] = {}
        for i in live:
            subgroups.setdefault(reqs[i].payload[4], []).append(i)
        n_forwards = 0
        est = self.estimator  # finalize must use the estimator that launched
        launched_subs: List[Tuple] = []
        for idxs in subgroups.values():
            query, cluster, _, _, _ = reqs[idxs[0]].payload
            mats = [reqs[i].payload[2] for i in idxs]
            sizes = [len(m) for m in mats]
            merged_mat = np.concatenate(mats, axis=0)
            try:
                parts = []
                for s in range(0, len(merged_mat), self.max_batch):
                    parts.append(
                        self.estimator.score(
                            query, cluster, merged_mat[s : s + self.max_batch],
                            metrics, deferred=True,
                        )
                    )
                    n_forwards += 1
                launched_subs.append((idxs, sizes, parts, None, query, cluster, merged_mat))
            except BaseException as e:
                launched_subs.append((idxs, sizes, None, e, query, cluster, merged_mat))

        def retry_sub(query, cluster, merged_mat, first_err):
            def attempt():
                done = []
                for s in range(0, len(merged_mat), self.max_batch):
                    done.append(
                        est.score(query, cluster, merged_mat[s : s + self.max_batch], metrics)
                    )
                return {m: np.concatenate([d[m] for d in done]) for m in metrics}

            return self._retry_call(attempt, first_err)

        def finalize():
            for idxs, sizes, parts, err, query, cluster, merged_mat in launched_subs:
                joined = None
                if err is None:
                    try:
                        done = [p.result() for p in parts]
                        joined = {m: np.concatenate([d[m] for d in done]) for m in metrics}
                    except BaseException as e:
                        err = e
                if joined is None:
                    try:
                        joined = retry_sub(query, cluster, merged_mat, err)
                    except BaseException as final:
                        for i in idxs:
                            q, c, a, ms, _ = reqs[i].payload
                            answers[i] = self._degraded_answer(q, c, a, ms, cause=final)
                        continue
                off = 0
                for i, size in zip(idxs, sizes):
                    answers[i] = {m: joined[m][off : off + size] for m in metrics}
                    off += size
            return answers, n_forwards, 0

        return finalize

    def _launch_estimates(self, reqs: List[_Request]) -> Callable:
        metrics = reqs[0].payload[1]
        graphs = [r.payload[0] for r in reqs]
        sizes = [int(np.asarray(g.op_x).shape[0]) for g in graphs]
        total = sum(sizes)
        if total == 0:
            raise ValueError("no graphs to estimate")
        # estimate_many merges along the batch axis and max_batch-chunks.
        # Unmergeable metrics (heterogeneous configs) chunk per batch
        # instead, so count what was actually issued
        pending = self.estimator.estimate_many(
            graphs, metrics, max_rows=self.max_batch, deferred=True
        )
        if self.estimator.supports_cross_query(metrics):
            n_forwards = -(-total // self.max_batch)
        else:
            n_forwards = sum(-(-n // self.max_batch) for n in sizes if n)
        est = self.estimator  # finalize must use the estimator that launched

        def finalize():
            try:
                results = pending.result()
            except BaseException as e:
                # estimates have no heuristic fallback: retry transients, then
                # deliver the error to the callers
                results = self._retry_call(
                    lambda: est.estimate_many(graphs, metrics, max_rows=self.max_batch),
                    e,
                )
            return results, n_forwards, 0

        return finalize

    # -- failure handling -------------------------------------------------

    @staticmethod
    def _transient(e: BaseException) -> bool:
        # caller errors and typed verdicts won't change on a second try;
        # everything else (backend hiccups, injected faults, CUDA errors
        # such as torch.cuda.OutOfMemoryError) may
        return isinstance(e, Exception) and not isinstance(
            e, (ValueError, NonFiniteEstimate, EstimateTimeoutError, ServiceOverloadError)
        )

    def _retry_call(self, fn: Callable, first_err: BaseException):
        """Re-run ``fn`` under the policy's RetryPolicy after ``first_err``.

        Raises the last error if every attempt fails or the error is not
        transient.  Sleeps are seeded-jittered exponential backoff, so a
        given service seed replays the same schedule.
        """
        if not self._transient(first_err):
            raise first_err
        last = first_err
        for attempt in range(1, self._retry.max_attempts):
            with self._cond:
                self.stats.n_retries += 1
            time.sleep(self._retry.sleep_s(attempt, float(self._rng.random())))
            try:
                return fn()
            except BaseException as e:
                last = e
                if not self._transient(e):
                    raise
        raise last

    def _degraded_answer(self, query, cluster, assignments, metrics, cause):
        """Heuristic-placement fallback scores, tagged ``degraded=True``.

        Used when the breaker is open (``cause=None``) or when the estimator
        failed past its retry budget (``cause`` = the final error).  If even
        the model-free fallback fails, the original cause is delivered.
        """
        try:
            return _Degraded(
                fallback_scores(query, cluster, assignments, metrics), cause=cause
            )
        except Exception as e:
            return cause if cause is not None else e
