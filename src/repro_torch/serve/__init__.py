"""Serving (the port of ``repro.serve``): train once offline, answer many
queries online.

* ``CostModelBundle`` — the versioned on-disk artifact holding every trained
  metric ensemble + configs + training metadata, readable by both packages;
* ``CostEstimator`` — the single inference facade (``estimate`` / ``score``
  / ``optimize`` and the cross-query ``estimate_many`` / ``score_many``);
* ``PlacementService`` — the micro-batching front-end that coalesces
  concurrent requests into fused forwards, with ``load`` (open-loop arrival
  schedules, latency quantiles, the saturation knee) beside it.

Dispatch tunables live on ``DispatchPolicy`` (``serve/policy.py``):
``autotune()`` calibrates them to the running host and ``resolve_policy()``
applies the persisted profile / env override.  The fault path is
``lifecycle`` — shadow-evaluated bundle hot-swap with rollback
(``BundleSwapper``), circuit-breaker degradation (``CircuitBreaker`` +
``fallback_scores``) — and ``chaos``, the seeded fault injectors that go
through the estimator's hook seam.
"""

from repro_torch.serve.bundle import (
    BUNDLE_SCHEMA_VERSION,
    BundleIntegrityError,
    BundleVersionError,
    CostModelBundle,
    LazyModels,
    bundle_from_checkpoint,
    corpus_fingerprint,
    layout_descriptor,
    merge_bundles,
)
from repro_torch.serve.estimator import CostEstimator, DeferredResult, NonFiniteEstimate
from repro_torch.serve.lifecycle import (
    BundleSwapper,
    CircuitBreaker,
    ShadowRejected,
    ShadowVerdict,
    fallback_scores,
)
from repro_torch.serve.policy import (
    AutotuneResult,
    DispatchPolicy,
    DispatchProfileWarning,
    RetryPolicy,
    active_policy,
    autotune,
    host_fingerprint,
    load_profile,
    profile_path,
    resolve_policy,
    save_profile,
    use_policy,
)
from repro_torch.serve.stacking import StackedEnsembles, stack_metric_models
from repro_torch.serve.load import (
    KneePoint,
    LoadReport,
    bursty_arrivals,
    find_knee,
    latency_quantiles,
    poisson_arrivals,
    run_open_loop,
    score_request_stream,
)
from repro_torch.serve.service import (
    EstimateTimeoutError,
    PlacementService,
    ServiceOverloadError,
    ServiceStats,
)

__all__ = [
    "AutotuneResult",
    "BUNDLE_SCHEMA_VERSION",
    "BundleIntegrityError",
    "BundleSwapper",
    "BundleVersionError",
    "CircuitBreaker",
    "CostModelBundle",
    "CostEstimator",
    "DeferredResult",
    "DispatchPolicy",
    "DispatchProfileWarning",
    "EstimateTimeoutError",
    "KneePoint",
    "LazyModels",
    "LoadReport",
    "NonFiniteEstimate",
    "PlacementService",
    "RetryPolicy",
    "ServiceOverloadError",
    "ServiceStats",
    "ShadowRejected",
    "ShadowVerdict",
    "StackedEnsembles",
    "active_policy",
    "autotune",
    "bundle_from_checkpoint",
    "bursty_arrivals",
    "corpus_fingerprint",
    "fallback_scores",
    "find_knee",
    "host_fingerprint",
    "latency_quantiles",
    "layout_descriptor",
    "load_profile",
    "merge_bundles",
    "poisson_arrivals",
    "profile_path",
    "resolve_policy",
    "save_profile",
    "score_request_stream",
    "stack_metric_models",
    "use_policy",
]
