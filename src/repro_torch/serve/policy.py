"""``DispatchPolicy``: every serving dispatch tunable in ONE calibrated object.

The port of ``repro/serve/policy.py``, with the same fields, defaults,
validation and profile format, so a profile written by either package
validates in the other.  All tunables live on a frozen, JSON-serializable
``DispatchPolicy``, and ``autotune()`` measures the real crossovers on the
running host with short seeded probes.

The policy is strictly a *performance* object: any valid policy yields
float-identical ``score``/``estimate`` results (test-pinned) — it decides how
work is batched, routed, chunked, and cached, never what is computed.

Resolution order (``resolve_policy``), applied by ``CostEstimator`` /
``PlacementService`` when constructed without an explicit ``policy=``:

1. ``REPRO_DISPATCH_PROFILE`` env var — ``"default"`` (or ``"none"``/``"0"``)
   pins the built-in defaults (CI and tests use this so routing assertions
   and perf baselines stay comparable across containers); any other value is
   a profile JSON path, loaded without a host check (an explicit pin);
2. the per-host profile cache ``~/.cache/repro_torch/dispatch/<fingerprint>.json``
   written by ``autotune()`` — loaded only when its recorded host
   fingerprint matches this machine (a copied cache directory silently
   falling back to defaults instead of mis-tuning);
3. the built-in defaults.

Where the port differs from the JAX package:

* ``host_descriptor`` records the CUDA device's name and count and the
  torch and CUDA versions, so a profile tuned by the JAX package never
  host-matches the port's (its crossovers were measured on another stack);
* ``resolved_double_buffer`` takes the estimator's device: launch-ahead is
  on for ``cuda`` and off for ``cpu``, the JAX package's backend rule;
* the port runs eagerly and its CUDA kernels size their own grids, so it
  reads neither ``trace_cache_size`` nor the kernel tile caps
  ``sweep_tile_rows`` / ``seg_gather_tile``; they stay validated fields so
  profiles round-trip, and ``autotune`` records the tile probe as skipped.

Cache-capacity sizing rationale (the ONE place these numbers live): each
capacity scales with rebuild-cost over per-entry footprint, anchored on
``trace_cache_size``: banding plans are tiny pure-Python tuples (2x);
featurized skeletons hold device-resident tensors (1/4); merged cross-query
groups hold a whole device skeleton *stack* per entry (1/8).

CLI::

    python -m repro_torch.serve.policy --quick [--device cpu|cuda] [--out PATH]
        [--budget-s S] [--expect-cached]   # fail if a probe ran
    python -m repro_torch.serve.policy --validate PATH
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import platform
import time
import warnings
from dataclasses import asdict, dataclass, fields, replace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

#: Bump when the profile JSON layout changes; older profiles are ignored
#: (fall back to defaults), never misread.
PROFILE_SCHEMA_VERSION = 1

#: Env var: "default"/"none"/"0" pins built-in defaults; otherwise a path.
PROFILE_ENV = "REPRO_DISPATCH_PROFILE"

_DEFAULT_CACHE_DIR = Path("~/.cache/repro_torch/dispatch")


class DispatchProfileWarning(UserWarning):
    """A dispatch profile exists on disk but was rejected (corrupt, stale,
    or recorded on another host) — the process runs built-in defaults."""


@dataclass(frozen=True)
class RetryPolicy:
    """Seeded exponential-backoff retry schedule for transient estimator
    failures (a view over the ``retry_*`` fields of ``DispatchPolicy``;
    consumed by ``PlacementService``).  ``max_attempts`` counts the first
    try: 1 disables retries."""

    max_attempts: int = 2
    backoff_s: float = 0.02
    jitter: float = 0.5

    def sleep_s(self, attempt: int, u: float) -> float:
        """Backoff before retry ``attempt`` (1-based) given ``u`` ~ U(0,1)."""
        return self.backoff_s * (2.0 ** (attempt - 1)) * (1.0 + u * self.jitter)


@dataclass(frozen=True)
class DispatchPolicy:
    """Every tunable the serving stack used to inline as a magic constant.

    Frozen and hashable.  All fields are performance knobs — see the module
    docstring for the invariant (results never depend on the policy) and for
    the three fields the port validates but does not read.
    """

    # -- routing crossovers (host-measurable; autotune targets) -----------------
    #: Merged-vs-per-structure drain crossover: a score drain averaging at
    #: most this many candidate rows per structure is dispatch-bound and
    #: merges into one cross-query forward; above it, per-structure
    #: specialized forwards win their dispatch back.  None: always merge.
    cross_query_row_limit: Optional[int] = 16
    #: Candidate-panel width of the placed stacked forward
    #: (``gnn.apply_gnn_placed_stacked``): the scan chunk that keeps the
    #: per-stage activation working set cache-resident.  0 disables chunking.
    score_chunk: int = 256
    # -- batching ----------------------------------------------------------------
    #: Rows (score) / graphs (estimate) per fused forward; oversized drains
    #: are chunked to this width (``PlacementService.max_batch`` and the
    #: estimator's ``max_rows``).
    max_batch: int = 1024
    #: First-seen runtime structure mixes admitted to the merged path
    #: (compile-cache bound under open-loop arrivals).  None: unbounded.
    max_merged_mixes: Optional[int] = 32
    #: Drain pipelining: None = auto (on for a CUDA estimator, off on the
    #: CPU where host and device share cores); True/False forces.
    double_buffer: Optional[bool] = None
    #: ``start()`` warmup breadth: candidate buckets run per warmed
    #: structure (powers of two up to this).
    warmup_cands: int = 8
    # -- kernel tiling (the JAX package's Pallas kernels) ------------------------
    #: Batch-row tile cap of the JAX package's fused stage-3 sweep kernel.
    #: The port reads it nowhere: its ``mp_sweep`` sizes its own grid.
    sweep_tile_rows: int = 128
    #: Batch-row tile cap of the JAX package's segment gather/scatter
    #: kernels.  The port reads it nowhere, as ``sweep_tile_rows``.
    seg_gather_tile: int = 128
    # -- placement search --------------------------------------------------------
    #: Default candidate-sample size of ``PlacementOptimizer.optimize``.
    search_k: int = 64
    #: Elites mutated per hill-climb refinement round (the refinement top-k).
    refine_top: int = 8
    # -- continuous placement controller (control/; docs/controller.md) ----------
    #: Telemetry tick interval [simulated s].  30 s matches the Storm-style
    #: monitoring loop of the Exp-2b baseline and gives 8 ticks per paper
    #: 4-minute measurement window — coarse enough that one tick amortizes a
    #: fused re-scoring pass, fine enough to catch drift inside one window.
    controller_tick_s: float = 30.0
    #: Drift-detector window [ticks]: EWMA span and CUSUM minimum run length.
    #: 4 ticks = 2 minutes of telemetry — half a measurement window, the
    #: shortest span over which the simulator's log-normal measurement noise
    #: (sigma=0.12) averages well below real drift steps (>= log 2).
    detector_window: int = 4
    #: CUSUM alarm level on the log(observed/predicted) cost residual.  With
    #: per-tick noise sigma ~= 0.12 and the detector's slack k = 2*sigma, a
    #: sustained 2x cost drift (residual ~= 0.7) crosses 1.5 within ~3 ticks
    #: while pure noise needs a >12-sigma excursion — alarms inside one
    #: detector window without firing on measurement noise.
    drift_threshold: float = 1.5
    #: Max window-state bytes one re-placement may move [MB], modeled as
    #: migration downtime.  64 MB covers the full state of typical corpus
    #: windows (count windows of ~1e3-1e4 tuples at ~100 B/tuple with JVM
    #: overhead) while excluding bulk moves of several large stateful ops at
    #: once; 0 disables migrations entirely (detect-only mode).
    migration_budget_mb: float = 64.0
    #: Ticks a re-placed query is held before it may re-plan again.  3 ticks
    #: covers detector_window - 1 post-migration samples, so the detector
    #: re-arms on post-move telemetry instead of thrashing on the residual
    #: spike the migration itself caused.  0 disables the cooldown.
    replan_cooldown_ticks: int = 3
    #: Re-placement search breadth: candidate sub-assignments scored per
    #: affected query.  Half of ``search_k``: the frozen prefix shrinks the
    #: space (only affected ops move), and re-plan latency is an SLO — 32
    #: rows ride one fused forward well under the p95 gate in
    #: benchmarks/controller_bench.py.
    replan_k: int = 32
    # -- serving robustness (serve.lifecycle + serve.service; docs/robustness.md)
    #: Fraction of drained score requests mirrored through a shadow candidate
    #: estimator during a ``BundleSwapper`` shadow phase.  0.5 halves the
    #: shadow-side device load while still covering every structure in a
    #: mixed stream within ~2x ``shadow_min_requests`` drains.
    shadow_fraction: float = 0.5
    #: Minimum mirrored requests before a shadow verdict may accept; below
    #: this the divergence statistics are noise and ``promote`` rejects with
    #: an "insufficient shadow traffic" verdict rather than guessing.
    shadow_min_requests: int = 8
    #: Minimum Spearman rank correlation between candidate and live placement
    #: orderings.  Placement search consumes *orderings*, not absolute costs
    #: (argmin over candidates), so rank agreement is the acceptance signal
    #: that predicts identical placement decisions; 0.8 tolerates local
    #: re-ranking among near-ties while rejecting models that invert rankings.
    shadow_rank_corr_min: float = 0.8
    #: Maximum mean relative cost error of the candidate vs the live answers.
    #: Guards the cost *magnitudes* the controller's drift detector consumes
    #: (a rank-preserving 3x inflation would trip every CUSUM alarm); 0.25
    #: stays under the detector's sustained-drift alarm level (log 2 ~= 0.7).
    shadow_rel_err_max: float = 0.25
    #: Bound on the shadow mirror queue (requests awaiting candidate scoring
    #: off the critical path).  When full, new mirror samples are dropped —
    #: shadow evaluation sheds load, it never backpressures live traffic.
    shadow_queue_depth: int = 64
    #: Drained requests observed after a promotion before the health verdict.
    #: One breaker window (x2) of post-swap traffic: long enough to see a
    #: systematic regression, short enough to roll back within seconds.
    health_window_requests: int = 32
    #: Max (degraded + non-finite + failed + timed-out) / drained over the
    #: post-promotion health window before auto-rollback.  0.1 sits well
    #: above the healthy-path error rate (~0 on a good bundle) and below the
    #: breaker's open threshold — rollback fires before the breaker trips.
    health_error_rate_max: float = 0.1
    #: Total attempts per estimator call (1 = no retry).  2 covers the
    #: transient single-shot failures chaos testing injects without letting
    #: a deterministic failure triple drain latency.
    retry_max_attempts: int = 2
    #: Base of the seeded exponential backoff between retries [s]: attempt k
    #: sleeps ``retry_backoff_s * 2**k * (1 + U(0,1) * retry_jitter)``.  20 ms
    #: is one drain's worth of budget — enough for a GC pause or allocator
    #: hiccup to clear, small enough to stay inside a request deadline.
    retry_backoff_s: float = 0.02
    #: Uniform jitter fraction on the backoff (decorrelates retry storms
    #: across workers; 0 disables).
    retry_jitter: float = 0.5
    #: Sliding window [request outcomes] the circuit breaker evaluates.
    #: One max-size drain (16 cross-query rows) of history: the breaker
    #: reacts to the current failure mode, not to stale incidents.
    breaker_window: int = 16
    #: Failure fraction over the window that opens the breaker.  0.5 means a
    #: majority of recent forwards failed — the estimator is effectively
    #: down, and heuristic answers beat a coin-flip estimator.
    breaker_failure_rate: float = 0.5
    #: Outcomes required in-window before the rate is trusted (a single
    #: failure after idle must not open the breaker).
    breaker_min_samples: int = 4
    #: Seconds the breaker stays open before half-open probes the estimator
    #: with one real request.  0.5 s covers a device reset or cache refill
    #: without serving minutes of heuristic answers after recovery.
    breaker_cooldown_s: float = 0.5
    # -- cache capacities (sizing rationale: module docstring) -------------------
    #: The JAX package's jitted-forward trace entries, the budget anchor of
    #: the capacities below.  The port runs eagerly and reads it nowhere.
    trace_cache_size: int = 256
    #: Stage-3 banding plans (``core.bucketing``): tiny tuples, 2x traces.
    banding_cache_size: int = 512
    #: Device-resident (query, cluster) skeleton entries: trace/4.
    skeleton_cache_size: int = 64
    #: Merged cross-query groups (device skeleton stacks): trace/8.
    merged_group_cache_size: int = 32

    # -- validation / serialization ---------------------------------------------

    def validate(self) -> "DispatchPolicy":
        """Raise ``ValueError`` on an out-of-range field; return self."""

        def _positive(name: str, allow_none: bool = False, allow_zero: bool = False):
            v = getattr(self, name)
            if v is None:
                if not allow_none:
                    raise ValueError(f"DispatchPolicy.{name} must not be None")
                return
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f"DispatchPolicy.{name} must be an int, got {v!r}")
            if v < 0 or (v == 0 and not allow_zero):
                raise ValueError(f"DispatchPolicy.{name} must be positive, got {v}")

        def _positive_f(name: str, allow_zero: bool = False):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"DispatchPolicy.{name} must be a number, got {v!r}")
            if not math.isfinite(v) or v < 0 or (v == 0 and not allow_zero):
                raise ValueError(f"DispatchPolicy.{name} must be positive, got {v}")

        def _fraction(name: str, lo: float = 0.0, hi: float = 1.0, allow_lo: bool = True):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"DispatchPolicy.{name} must be a number, got {v!r}")
            if not math.isfinite(v) or v > hi or v < lo or (v == lo and not allow_lo):
                raise ValueError(
                    f"DispatchPolicy.{name} must be in [{lo}, {hi}], got {v}"
                )

        _positive("cross_query_row_limit", allow_none=True, allow_zero=True)
        _positive("score_chunk", allow_zero=True)
        _positive("max_batch")
        _positive("max_merged_mixes", allow_none=True, allow_zero=True)
        _positive("sweep_tile_rows")
        _positive("seg_gather_tile")
        _positive("warmup_cands")
        _positive("search_k")
        _positive("refine_top")
        _positive_f("controller_tick_s")
        _positive("detector_window")
        _positive_f("drift_threshold")
        _positive_f("migration_budget_mb", allow_zero=True)
        _positive("replan_cooldown_ticks", allow_zero=True)
        _positive("replan_k")
        _fraction("shadow_fraction")
        _positive("shadow_min_requests")
        _fraction("shadow_rank_corr_min", lo=-1.0)
        _positive_f("shadow_rel_err_max")
        _positive("shadow_queue_depth")
        _positive("health_window_requests")
        _fraction("health_error_rate_max", allow_lo=False)
        _positive("retry_max_attempts")
        _positive_f("retry_backoff_s", allow_zero=True)
        _fraction("retry_jitter")
        _positive("breaker_window")
        _fraction("breaker_failure_rate", allow_lo=False)
        _positive("breaker_min_samples")
        _positive_f("breaker_cooldown_s", allow_zero=True)
        if self.breaker_min_samples > self.breaker_window:
            raise ValueError(
                "DispatchPolicy.breaker_min_samples must not exceed "
                f"breaker_window ({self.breaker_min_samples} > {self.breaker_window})"
            )
        _positive("trace_cache_size")
        _positive("banding_cache_size")
        _positive("skeleton_cache_size")
        _positive("merged_group_cache_size")
        if self.double_buffer not in (None, True, False):
            raise ValueError(
                f"DispatchPolicy.double_buffer must be None/True/False, "
                f"got {self.double_buffer!r}"
            )
        return self

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DispatchPolicy":
        """Strict inverse of ``to_dict``: unknown keys raise (schema guard)."""
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown DispatchPolicy fields: {sorted(unknown)}")
        return cls(**d).validate()

    def retry_policy(self) -> RetryPolicy:
        """The ``retry_*`` fields as one ``RetryPolicy`` view."""
        return RetryPolicy(
            max_attempts=self.retry_max_attempts,
            backoff_s=self.retry_backoff_s,
            jitter=self.retry_jitter,
        )

    def resolved_double_buffer(self, device) -> bool:
        """The device-auto rule, applied: launch-ahead only pays where device
        compute runs beside the host (``device`` is a CUDA device); on the
        CPU they share cores, so the split just fragments drains."""
        if self.double_buffer is not None:
            return bool(self.double_buffer)
        return torch.device(device).type != "cpu"


# -- host identity ----------------------------------------------------------------


def host_descriptor() -> Dict[str, object]:
    """The hardware/runtime identity a tuned profile is valid for."""
    cuda = torch.cuda.is_available()
    return {
        "node": platform.node(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count(),
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def host_fingerprint(descriptor: Optional[Dict] = None) -> str:
    """Stable digest of ``host_descriptor()`` — the profile cache key."""
    d = descriptor if descriptor is not None else host_descriptor()
    blob = json.dumps(d, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def profile_path(fingerprint: Optional[str] = None) -> Path:
    """The per-host profile cache location (ignores the env override)."""
    fp = fingerprint if fingerprint is not None else host_fingerprint()
    return _DEFAULT_CACHE_DIR.expanduser() / f"{fp}.json"


# -- profile persistence ----------------------------------------------------------


def save_profile(
    path,
    policy: DispatchPolicy,
    measurements: Optional[Dict] = None,
    descriptor: Optional[Dict] = None,
) -> Path:
    """Write a host-stamped profile JSON (parents created, atomic rename)."""
    policy.validate()
    d = descriptor if descriptor is not None else host_descriptor()
    payload = {
        "schema_version": PROFILE_SCHEMA_VERSION,
        "host_fingerprint": host_fingerprint(d),
        "host": d,
        "policy": policy.to_dict(),
        "measurements": measurements or {},
    }
    path = Path(path).expanduser()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
    tmp.replace(path)
    return path


def load_profile(path, require_host_match: bool = True) -> Optional[Dict]:
    """Parsed+validated profile dict, or None when it must not be used.

    ``None`` — never an exception — on: missing file, unparseable JSON,
    schema-version mismatch, invalid policy fields, or (when
    ``require_host_match``) a recorded fingerprint from another machine.  A
    missing file is the normal untuned-host case and stays silent; a file
    that *exists* but cannot be used emits one ``DispatchProfileWarning``
    naming the path and reason, so operators can tell a tuned host from one
    silently running defaults on top of a corrupt profile.
    """

    def _reject(reason: str) -> None:
        warnings.warn(
            f"ignoring dispatch profile {path}: {reason} "
            "(falling back to built-in defaults)",
            DispatchProfileWarning,
            stacklevel=3,
        )

    path = Path(path).expanduser()
    if not path.exists():
        return None
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        _reject(f"unreadable or unparseable ({e.__class__.__name__})")
        return None
    if not isinstance(payload, dict):
        _reject("payload is not a JSON object")
        return None
    if payload.get("schema_version") != PROFILE_SCHEMA_VERSION:
        _reject(
            f"schema version {payload.get('schema_version')!r} != "
            f"{PROFILE_SCHEMA_VERSION} (stale profile)"
        )
        return None
    try:
        policy = DispatchPolicy.from_dict(payload.get("policy", {}))
    except (TypeError, ValueError) as e:
        _reject(f"invalid policy payload ({e})")
        return None
    if require_host_match and payload.get("host_fingerprint") != host_fingerprint():
        _reject("recorded host fingerprint is from another machine")
        return None
    payload["policy_obj"] = policy
    return payload


def resolve_policy() -> DispatchPolicy:
    """Env override -> cached host profile -> built-in defaults."""
    env = os.environ.get(PROFILE_ENV)
    if env is not None:
        if env.strip().lower() in ("", "default", "none", "0"):
            return DispatchPolicy()
        prof = load_profile(env, require_host_match=False)  # explicit pin
        if prof is None:
            raise ValueError(
                f"{PROFILE_ENV}={env!r} does not point at a valid dispatch profile"
            )
        return prof["policy_obj"]
    prof = load_profile(profile_path(), require_host_match=True)
    if prof is not None:
        return prof["policy_obj"]
    return DispatchPolicy()


# -- the process-wide active policy ----------------------------------------------
#
# Module-level consumers that cannot carry an instance policy (the banding
# cache in core.bucketing and the chunk fallback in core.gnn) read
# capacities from here.  Resolved lazily on first use so the env override and host profile
# apply process-wide; tests scope overrides with ``use_policy``.

_ACTIVE: Optional[DispatchPolicy] = None


def active_policy() -> DispatchPolicy:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = resolve_policy()
    return _ACTIVE


def set_active_policy(policy: Optional[DispatchPolicy]) -> None:
    """Set (or, with None, re-resolve on next use) the process-wide policy."""
    global _ACTIVE
    _ACTIVE = policy.validate() if policy is not None else None


@contextlib.contextmanager
def use_policy(policy: DispatchPolicy):
    """Scoped ``set_active_policy`` (tests, autotune probes)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = policy.validate()
    try:
        yield policy
    finally:
        _ACTIVE = prev


# -- autotune ---------------------------------------------------------------------


@dataclass
class AutotuneResult:
    policy: DispatchPolicy
    measurements: Dict[str, object]
    reused_cached: bool  # True: a valid profile existed, no probe ran
    path: Optional[Path] = None


def _probe_estimator(hidden: int = 24, n_ensemble: int = 2, seed: int = 0, device=None):
    """A tiny randomly-initialized estimator: dispatch crossovers depend on
    shapes and launch counts, never on trained weights."""
    from repro_torch.core.gnn import GNNConfig
    from repro_torch.core.model import CostModelConfig, init_cost_model
    from repro_torch.serve.estimator import CostEstimator

    models = {}
    for i, metric in enumerate(("latency_p", "success")):
        cfg = CostModelConfig(
            metric=metric, n_ensemble=n_ensemble, gnn=GNNConfig(hidden=hidden)
        )
        models[metric] = (init_cost_model(torch.Generator().manual_seed(seed + i), cfg), cfg)
    return CostEstimator(models, policy=DispatchPolicy(), device=device)


def _best_of(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _probe_structures(n: int, seed: int) -> List[Tuple]:
    from repro_torch.dsps.generator import WorkloadGenerator

    gen = WorkloadGenerator(seed=seed)
    kinds = ("linear", "two_way", "three_way")
    return [
        (gen.query(kind=kinds[i % len(kinds)], name=f"tune{i}"), gen.cluster(3 + i % 4))
        for i in range(n)
    ]


def _measure_cross_query_crossover(
    est, probes: Tuple[int, ...], repeats: int, seed: int
) -> Tuple[Optional[int], Dict]:
    """Largest probed rows-per-structure where the merged drain still beats
    the per-structure drain.  Always within the probed band — autotune
    interpolates between measurements, it never extrapolates past them."""
    import numpy as np

    from repro_torch.placement.enumerate import sample_assignment_matrix

    structures = _probe_structures(4, seed)
    metrics = tuple(est.models)
    rng = np.random.default_rng(seed)
    band: Dict[str, Dict[str, float]] = {}
    crossover = None
    for rows in probes:
        items = [
            (q, c, sample_assignment_matrix(q, c, rows, rng, max_tries_factor=400))
            for q, c in structures
        ]
        items = [(q, c, a) for q, c, a in items if len(a)]
        if len(items) < 2:
            continue

        def merged():
            est.score_many(items, metrics)

        def per_structure():
            for q, c, a in items:
                est.score(q, c, a, metrics)

        merged(), per_structure()  # warm both paths' traces outside the clock
        t_merged = _best_of(merged, repeats)
        t_per = _best_of(per_structure, repeats)
        band[str(rows)] = {"merged_s": t_merged, "per_structure_s": t_per}
        if t_merged < t_per:
            crossover = rows
    return crossover, band


def _measure_chunk_width(
    est, probes: Tuple[int, ...], batch: int, repeats: int, seed: int
) -> Tuple[Optional[int], Dict]:
    """Fastest placed-path panel width for a ``batch``-candidate scoring call."""
    import numpy as np

    from repro_torch.placement.enumerate import sample_assignment_matrix

    (q, c), = _probe_structures(1, seed + 101)
    rng = np.random.default_rng(seed)
    pool = sample_assignment_matrix(q, c, batch, rng, max_tries_factor=400)
    if not len(pool):
        return None, {}
    a = pool[np.arange(batch) % len(pool)]
    metrics = tuple(est.models)
    timings: Dict[str, float] = {}
    best_chunk, best_t = None, float("inf")
    for chunk in probes:
        if chunk and batch % chunk:
            continue  # the panel scan requires an integral panel count
        probe_est = type(est)(
            est.models, policy=replace(est.policy, score_chunk=chunk), device=est.device
        )

        def run():
            probe_est.score(q, c, a, metrics)

        run()  # warm this chunk's trace outside the clock
        t = _best_of(run, repeats)
        timings[str(chunk)] = t
        if t < best_t:
            best_chunk, best_t = chunk, t
    return best_chunk, timings


def _measure_kernel_tiles(
    probes: Tuple[int, ...], repeats: int, seed: int
) -> Tuple[Optional[int], Optional[int], Dict]:
    """The JAX package's batch-tile caps for its sweep and seg-gather kernels.

    The port's CUDA kernels size their own grids and take no tile cap, so
    ``sweep_tile_rows`` / ``seg_gather_tile`` are dead knobs here: the probe
    records why it skipped instead of writing noise into the profile, as the
    JAX package's probe does on its jnp-oracle lowering."""
    return None, None, {
        "skipped": "CUDA kernels size their own grids: kernel tile caps are unused"
    }


def autotune(
    quick: bool = False,
    budget_s: Optional[float] = None,
    seed: int = 0,
    out: Optional[os.PathLike] = None,
    force: bool = False,
    base: Optional[DispatchPolicy] = None,
    device=None,
) -> AutotuneResult:
    """Measure this host's dispatch crossovers and persist a profile.

    Short seeded probes (deterministic request streams, best-of-repeats
    timing — the ``serve.load`` calibration methodology) measure

    * the merged-vs-per-structure drain crossover -> ``cross_query_row_limit``
      (selected within the probed band, never extrapolated);
    * the placed-path panel width -> ``score_chunk``;
    * the kernel batch-tile caps: skipped, recorded as such (the CUDA
      kernels size their own grids).

    Everything else keeps ``base`` (default: the built-in defaults) — those
    knobs are capacity bounds, not crossovers.  The profile is written to
    ``out`` (default: ``profile_path()``); a second call finding a valid
    same-host profile at that path is a NO-OP (``reused_cached=True``, no
    probe runs) unless ``force``.  ``budget_s`` is a wall-clock bound: when
    it expires mid-run, un-probed knobs keep their defaults and the profile
    records ``budget_exhausted``.  The probes run on ``device`` (None: the
    GPU, as every entry point of the port).
    """
    target = Path(out).expanduser() if out is not None else profile_path()
    if not force:
        cached = load_profile(target, require_host_match=True)
        if cached is not None:
            return AutotuneResult(
                policy=cached["policy_obj"],
                measurements=cached.get("measurements", {}),
                reused_cached=True,
                path=target,
            )
    base = (base or DispatchPolicy()).validate()
    t_start = time.perf_counter()

    def budget_left() -> bool:
        return budget_s is None or (time.perf_counter() - t_start) < budget_s

    repeats = 3 if quick else 5
    row_probes = (1, 4, 16) if quick else (1, 2, 4, 8, 16, 32)
    chunk_batch = 256 if quick else 512
    chunk_probes = (64, 256) if quick else (64, 128, 256, 512)
    tile_probes = (32, 128) if quick else (32, 64, 128, 256)

    measurements: Dict[str, object] = {
        "quick": quick,
        "seed": seed,
        "row_probes": list(row_probes),
        "chunk_probes": list(chunk_probes),
        "chunk_batch": chunk_batch,
        "tile_probes": list(tile_probes),
    }
    policy = base
    # probes run under the BASE policy so the estimator's own dispatch is the
    # documented default configuration while it is being measured
    with use_policy(base):
        est = _probe_estimator(seed=seed, device=device)
        if budget_left():
            crossover, band = _measure_cross_query_crossover(
                est, row_probes, repeats, seed
            )
            measurements["cross_query_band"] = band
            if crossover is not None:
                # merged never winning picks the smallest probe (merge only
                # trivially small drains); winning everywhere picks the
                # largest — the selection stays inside the measured band
                policy = replace(policy, cross_query_row_limit=crossover)
                measurements["cross_query_row_limit"] = crossover
        else:
            measurements["budget_exhausted"] = "before cross_query probe"
        if budget_left():
            chunk, timings = _measure_chunk_width(
                est, chunk_probes, chunk_batch, repeats, seed
            )
            measurements["chunk_timings_s"] = timings
            if chunk is not None:
                policy = replace(policy, score_chunk=chunk)
                measurements["score_chunk"] = chunk
        else:
            measurements.setdefault("budget_exhausted", "before chunk probe")
        if budget_left():
            sweep_tile, gather_tile, tile_meta = _measure_kernel_tiles(
                tile_probes, repeats, seed
            )
            measurements["kernel_tiles"] = tile_meta
            if sweep_tile is not None:
                policy = replace(policy, sweep_tile_rows=sweep_tile)
                measurements["sweep_tile_rows"] = sweep_tile
            if gather_tile is not None:
                policy = replace(policy, seg_gather_tile=gather_tile)
                measurements["seg_gather_tile"] = gather_tile
        else:
            measurements.setdefault("budget_exhausted", "before kernel tile probe")
    measurements["elapsed_s"] = round(time.perf_counter() - t_start, 3)
    path = save_profile(target, policy.validate(), measurements)
    return AutotuneResult(
        policy=policy, measurements=measurements, reused_cached=False, path=path
    )


# -- CLI ------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.policy", description=__doc__
    )
    ap.add_argument("--quick", action="store_true", help="small probe set for CI")
    ap.add_argument("--budget-s", type=float, default=None, help="wall-clock bound")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None, help="profile path (default: host cache)")
    ap.add_argument("--force", action="store_true", help="re-probe even if cached")
    ap.add_argument("--device", type=str, default=None, help="probe device (default: cuda)")
    ap.add_argument(
        "--expect-cached",
        action="store_true",
        help="fail unless a valid cached profile made this a no-op (CI gate)",
    )
    ap.add_argument(
        "--validate", type=str, default=None, metavar="PATH",
        help="validate a profile JSON against the schema and exit",
    )
    args = ap.parse_args(argv)

    if args.validate is not None:
        prof = load_profile(args.validate, require_host_match=False)
        if prof is None:
            print(f"INVALID dispatch profile: {args.validate}")
            return 1
        print(json.dumps({"valid": True, "policy": prof["policy"]}, indent=2))
        return 0

    res = autotune(
        quick=args.quick,
        budget_s=args.budget_s,
        seed=args.seed,
        out=args.out,
        force=args.force,
        device=args.device,
    )
    print(
        json.dumps(
            {
                "reused_cached": res.reused_cached,
                "path": str(res.path),
                "policy": res.policy.to_dict(),
                "measurements": res.measurements,
            },
            indent=2,
            default=str,
        )
    )
    if args.expect_cached and not res.reused_cached:
        print("expected a cached profile but a probe ran")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
