"""``CostEstimator``: the inference facade over trained cost models, in PyTorch.

The port of ``repro/serve/estimator.py``'s single-query surface: generic cost
estimation for placed queries (``estimate``, ``proba``), candidate-placement
scoring (``scorer``/``score``) and placement search (``optimize``), built
from an in-memory model dict or a ``CostModelBundle``.  It owns

* the device: every forward runs on ``device`` (default ``"cuda"``; a
  machine without a GPU raises unless the caller asks for ``"cpu"``);
* the per-(query, cluster) **skeleton LRU**: the featurized host skeleton,
  its device copy, and the ``QueryStatic``, shared by every ``score`` /
  ``optimize`` call on the same pair;
* the per-metrics-tuple **stacked-ensemble cache**: all requested metrics
  ride ONE fused forward (one kernel launch per stage) when their GNN
  configs are shape-identical.

PyTorch runs eagerly, so the JAX package's trace caches have no counterpart.
``deferred=True`` returns a ``DeferredResult`` once the forward is queued on
the device, before the results are copied to the host.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.gnn import apply_gnn_placed_members, apply_gnn_placed_stacked
from repro_torch.core.graph import (
    JointGraph,
    QueryStatic,
    batch_graphs,
    bucket_size,
    build_a_place_batch,
    build_graph,
    build_graph_skeleton,
    query_static,
    skeleton_cache_key,
)
from repro_torch.core.model import CostModelConfig, forward_ensemble
from repro_torch.serve.policy import DispatchPolicy, active_policy
from repro_torch.serve.stacking import (
    StackedEnsembles,
    _ensemble_vote,
    _split_votes,
    stack_metric_models,
)


class NonFiniteEstimate(RuntimeError):
    """An estimator output contained NaN/Inf.

    Raised by the always-on finiteness guard on every facade output instead
    of returning garbage costs to the optimizer: a NaN cost compares false
    against everything, so an argmin over candidates would silently pick an
    arbitrary placement.
    """


def _check_finite(kind: str, out):
    """Raise ``NonFiniteEstimate`` if any output array has NaN/Inf."""
    items = out if isinstance(out, (list, tuple)) else (out,)
    for d in items:
        if d is None:
            continue
        for m, v in d.items():
            v = np.asarray(v)
            if v.dtype.kind == "f" and not np.isfinite(v).all():
                bad = int(np.size(v) - np.count_nonzero(np.isfinite(v)))
                raise NonFiniteEstimate(
                    f"{kind} produced {bad} non-finite value(s) for metric "
                    f"{m!r} (shape {v.shape})"
                )
    return out


class DeferredResult:
    """Device work already queued; the host-side finalize is deferred.

    ``result()`` copies the device values to the host (which waits for the
    device) and runs the remaining host work (vote, split per metric).
    """

    __slots__ = ("_finalize", "_value", "_done")

    def __init__(self, finalize):
        self._finalize = finalize
        self._done = False
        self._value = None

    def result(self):
        if not self._done:
            self._value = self._finalize()
            self._finalize = None  # drop captured device buffers
            self._done = True
        return self._value


def _maybe_defer(finalize, deferred: bool):
    return DeferredResult(finalize) if deferred else finalize()


def _host(raw: torch.Tensor) -> np.ndarray:
    return raw.detach().cpu().numpy()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CostEstimator runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # the plain-PyTorch parts of the forward stay in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def graphs_to_device(g: JointGraph, device) -> JointGraph:
    """A host ``JointGraph`` of numpy arrays as contiguous tensors on ``device``."""
    return JointGraph(*[torch.as_tensor(np.ascontiguousarray(x), device=device) for x in g])


# -- stateless scoring primitives -------------------------------------------------
#
# The numeric cores behind the facade methods; ``params`` and the graphs
# must already be on one device.


def ensemble_predict(params, g: JointGraph, cfg: CostModelConfig) -> np.ndarray:
    """Ensemble prediction in *cost space* for a batch of graphs."""
    with torch.no_grad():
        raw = forward_ensemble(params, g, cfg)
    return _ensemble_vote(_host(raw), cfg)


def ensemble_proba(params, g: JointGraph, cfg: CostModelConfig) -> np.ndarray:
    """Mean over members of the per-member sigmoid probability."""
    if cfg.task != "classification":
        raise ValueError(f"proba needs a classification metric, not {cfg.metric!r}")
    with torch.no_grad():
        raw = _host(forward_ensemble(params, g, cfg))
    return (1.0 / (1.0 + np.exp(-raw))).mean(axis=0)


def placed_predict(
    params, skel: JointGraph, a_place: torch.Tensor, static: QueryStatic, cfg: CostModelConfig
) -> np.ndarray:
    """Ensemble prediction over candidate placements of ONE query.

    ``skel`` is the shared unbatched skeleton, ``a_place`` the ``(B, O, W)``
    placement adjacencies; numerically equivalent to ``ensemble_predict`` on
    the broadcast batch.
    """
    with torch.no_grad():
        raw = apply_gnn_placed_members(params, skel, a_place, static, cfg.gnn)[..., 0]
    return _ensemble_vote(_host(raw), cfg)


def placed_predict_fused(
    stacked: StackedEnsembles,
    skel: JointGraph,
    a_place: torch.Tensor,
    static: QueryStatic,
    deferred: bool = False,
    chunk: Optional[int] = None,
    n_hw: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """All metrics' ensembles over one query's candidate placements, fused.

    One ``apply_gnn_placed_stacked`` call evaluates every (metric, member)
    pair with one kernel launch per GNN stage, on the trimmed active-slot
    layout; the raw ``(sum_E, B)`` block is split back per metric and voted.
    ``n_hw`` (the skeleton's real host count) saves a device read when the
    caller knows it.
    """
    if stacked.cfgs[0].traditional_mp:
        raise ValueError("traditional_mp models have no placed forward")
    if n_hw is None:
        n_hw = int(skel.hw_mask.sum().item())
    if chunk is None:
        chunk = active_policy().score_chunk
    with torch.no_grad():
        raw = apply_gnn_placed_stacked(stacked.params, skel, a_place, static, stacked.cfgs[0].gnn, n_hw, chunk)
    return _maybe_defer(lambda: _split_votes(_host(raw), stacked), deferred)


# -- the facade -------------------------------------------------------------------


class CostEstimator:
    """Serving facade over a set of trained per-metric ensembles.

    ``models``: dict metric -> (params, CostModelConfig), exactly the shape
    ``CostModelBundle.models`` carries (``from_bundle`` is the one-liner);
    params may live on any device and are copied to ``device`` on first use.
    ``policy``: a ``DispatchPolicy`` (default: the built-in defaults).
    ``device``: where every forward runs; None means ``"cuda"`` and raises
    when no GPU is present.
    """

    def __init__(
        self,
        models: Dict[str, Tuple[object, CostModelConfig]],
        meta=None,
        policy: Optional[DispatchPolicy] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        # plain dicts are copied (callers may mutate theirs); other Mappings
        # (bundle.LazyModels) pass through so laziness survives the facade
        self.models = dict(models) if type(models) is dict else models
        if not isinstance(self.models, Mapping):
            raise TypeError(f"models must be a mapping, got {type(models)}")
        self.meta = dict(meta or {})
        self.policy = (policy if policy is not None else active_policy()).validate()
        self._skeletons: "OrderedDict[Tuple, Tuple[JointGraph, JointGraph, QueryStatic]]" = OrderedDict()
        self._stacked: Dict[Tuple[str, ...], Optional[StackedEnsembles]] = {}
        self._params: Dict[str, object] = {}  # metric -> params on self.device
        self._optimizer = None

    def _finish(self, kind: str, finalize, deferred: bool):
        """Wrap a finalize thunk with the finiteness guard."""
        return _maybe_defer(lambda: _check_finite(kind, finalize()), deferred)

    @classmethod
    def from_bundle(
        cls,
        bundle,
        corpus_fingerprint: Optional[str] = None,
        policy: Optional[DispatchPolicy] = None,
        strict_provenance: bool = False,
        device=None,
    ) -> "CostEstimator":
        """Facade over a bundle's models (laziness preserved).

        When both ``corpus_fingerprint`` and the bundle's recorded
        ``meta["corpus_fingerprint"]`` exist and disagree, a warning flags the
        provenance mismatch; ``strict_provenance=True`` raises
        ``BundleVersionError`` instead.
        """
        meta = bundle.meta or {}
        recorded = meta.get("corpus_fingerprint")
        if corpus_fingerprint is not None and recorded is not None and recorded != corpus_fingerprint:
            msg = (
                f"bundle was trained on corpus {recorded!r} but the caller "
                f"expects {corpus_fingerprint!r}; predictions are served "
                "against data the models never saw (provenance mismatch)"
            )
            if strict_provenance:
                from repro_torch.serve.bundle import BundleVersionError

                raise BundleVersionError(msg)
            warnings.warn(msg, stacklevel=2)
        return cls(bundle.models, meta=meta, policy=policy, device=device)

    @property
    def metrics(self) -> Tuple[str, ...]:
        return tuple(self.models)

    def config(self, metric: str) -> CostModelConfig:
        return self.models[metric][1]

    def _params_for(self, metric: str):
        """``metric``'s ensemble params on the estimator's device (cached)."""
        if metric not in self._params:
            self._params[metric] = nn.to_device(self.models[metric][0], self.device)
        return self._params[metric]

    # -- generic batch estimation -------------------------------------------------

    def _as_graphs(self, batch) -> JointGraph:
        """A batched ``JointGraph``, or a sequence of traces to featurize, on the device."""
        if not isinstance(batch, JointGraph):
            batch = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in batch])
        return graphs_to_device(batch, self.device)

    def estimate(
        self, batch, metrics: Optional[Sequence[str]] = None, deferred: bool = False
    ) -> Dict[str, np.ndarray]:
        """Cost-space predictions for a batch of *placed* queries.

        ``batch`` is either a batched ``JointGraph`` (numpy arrays) or a
        sequence of traces (anything with ``.query``/``.cluster``/
        ``.placement``), featurized here in one pass.  The batch moves to the
        device once; shape-identical per-metric configs run as ONE stacked
        forward (the full-depth scan plan), others as a per-metric loop.
        Returns metric -> predictions aligned with the batch.
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        g = self._as_graphs(batch)
        stacked = self._stacked_for(metrics)
        with torch.no_grad():
            if stacked is None:  # mixed architectures: per-metric forwards, shared batch
                raws = {m: forward_ensemble(self._params_for(m), g, self.models[m][1]) for m in metrics}
                return self._finish(
                    "estimate",
                    lambda: {m: _ensemble_vote(_host(raws[m]), self.models[m][1]) for m in metrics},
                    deferred,
                )
            raw = forward_ensemble(stacked.params, g, stacked.cfgs[0])
        return self._finish("estimate", lambda: _split_votes(_host(raw), stacked), deferred)

    def proba(self, batch, metric: str) -> np.ndarray:
        """Mean ensemble probability for one classification metric."""
        return ensemble_proba(self._params_for(metric), self._as_graphs(batch), self.models[metric][1])

    # -- placement scoring --------------------------------------------------------

    def _skeleton_entry(self, query, cluster) -> Tuple[JointGraph, JointGraph, QueryStatic]:
        """Cached (host skeleton, device skeleton, QueryStatic) for one pair."""
        key = skeleton_cache_key(query, cluster)
        hit = self._skeletons.get(key)
        if hit is not None:
            self._skeletons.move_to_end(key)
            return hit
        host = build_graph_skeleton(query, cluster)
        entry = (host, graphs_to_device(host, self.device), query_static(query))
        self._skeletons[key] = entry
        while len(self._skeletons) > self.policy.skeleton_cache_size:
            self._skeletons.popitem(last=False)
        return entry

    def _stacked_for(self, metrics: Tuple[str, ...]) -> Optional[StackedEnsembles]:
        """Fused ensemble stack for ``metrics`` on the device, or None if not fusable."""
        if metrics not in self._stacked:
            try:
                stacked = stack_metric_models(self.models, metrics)
            except ValueError:  # heterogeneous per-metric configs
                self._stacked[metrics] = None
            else:
                self._stacked[metrics] = stacked._replace(params=nn.to_device(stacked.params, self.device))
        return self._stacked[metrics]

    def scorer(self, query, cluster, metrics: Sequence[str], deferred: bool = False):
        """Scoring closure with the per-(query, cluster) work hoisted out.

        The skeleton, its device copy and the ``QueryStatic`` come from the
        LRU (at most ONE skeleton build per pair), and every scored batch is
        one fused stacked forward.  ``deferred`` makes the closure return a
        ``DeferredResult``.
        """
        metrics = tuple(metrics)
        if any(self.models[m][1].traditional_mp for m in metrics):
            raise NotImplementedError(
                "scoring traditional_mp models is not ported yet: ROADMAP.md queue 1, item 8"
            )
        host, skel, static = self._skeleton_entry(query, cluster)
        n_hw = int(host.hw_mask.sum())
        stacked = self._stacked_for(metrics)

        def score(assignments: np.ndarray) -> Dict[str, np.ndarray]:
            n = len(assignments)
            if n == 0:
                raise ValueError("no candidates to score")
            a_place = build_a_place_batch(query, cluster, assignments)
            pad = bucket_size(n) - n
            if pad:
                a_place = np.concatenate([a_place, np.repeat(a_place[-1:], pad, axis=0)])
            a_place = torch.as_tensor(a_place, device=self.device)
            if stacked is not None:
                pending = placed_predict_fused(
                    stacked, skel, a_place, static, deferred=True,
                    chunk=self.policy.score_chunk, n_hw=n_hw,
                )
                return self._finish(
                    "score", lambda: {m: v[:n] for m, v in pending.result().items()}, deferred
                )
            # heterogeneous (non-fusable) configs: per-metric loop
            out = {
                m: placed_predict(self._params_for(m), skel, a_place, static, self.models[m][1])[:n]
                for m in metrics
            }
            return self._finish("score", lambda: out, deferred)

        return score

    def score(
        self,
        query,
        cluster,
        assignments: np.ndarray,
        metrics: Optional[Sequence[str]] = None,
        deferred: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Score an ``(N, n_ops)`` assignment matrix on every requested metric.

        One skeleton build per (query, cluster) pair (LRU-amortized), one
        bucket-padded stacked forward per call; padding rows are sliced off,
        so results are independent of the bucket and of batchmates.
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        return self.scorer(query, cluster, metrics, deferred=deferred)(
            np.asarray(assignments, dtype=np.int64)
        )

    def optimize(self, query, cluster, target_metric: str = "latency_p", **kwargs):
        """Cost-based placement search (paper SV): sample -> score -> argopt.

        Delegates to a ``PlacementOptimizer`` sharing this estimator and its
        caches; see that class for the search knobs (``k``,
        ``refine_rounds``, ...).
        """
        if self._optimizer is None:
            from repro_torch.placement.optimizer import PlacementOptimizer

            self._optimizer = PlacementOptimizer(self)
        return self._optimizer.optimize(query, cluster, target_metric, **kwargs)
