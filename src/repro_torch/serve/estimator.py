"""``CostEstimator``: the inference facade over trained cost models, in PyTorch.

The port of ``repro/serve/estimator.py``: generic cost estimation for placed
queries (``estimate``, ``proba``), candidate-placement scoring (``scorer`` /
``score``), placement search (``optimize``), and the cross-query paths that
answer many requests in one forward (``estimate_many``, ``score_many``),
built from an in-memory model dict or a ``CostModelBundle``.  It owns

* the device: every forward runs on ``device`` (default ``"cuda"``; a
  machine without a GPU raises unless the caller asks for ``"cpu"``);
* the per-(query, cluster) **skeleton LRU**: the featurized host skeleton,
  its device copy, and the ``QueryStatic``, shared by every ``score`` /
  ``optimize`` call on the same pair;
* the per-metrics-tuple **stacked-ensemble cache**: all requested metrics
  ride ONE fused forward (one kernel launch per stage) when their GNN
  configs are shape-identical;
* the per-drain-mix **merged-group LRU** of ``score_many``: the device
  skeleton stack of a set of structures, its banding and its parent bound.

PyTorch runs eagerly, so the JAX package's trace caches have no counterpart,
and buffer donation none either (PyTorch frees a chunk's inputs when the last
reference goes).  ``deferred=True`` returns a ``DeferredResult`` once the
forward is queued on the device, before the results are copied to the host;
on a GPU that dispatch half waits for nothing on the host (host arrays reach
the device through one page-locked buffer and a ``non_blocking`` copy,
``nn.arrays_to_device``), so ``PlacementService`` can launch one drain while
the device still runs the previous one.  ``add_hook`` is the fault-injection
and observation seam (``serve/chaos.py``): ``before`` at dispatch, ``after``
at finalize, ahead of the finiteness guard.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.gnn import (
    apply_gnn_merged,
    apply_gnn_placed_members,
    apply_gnn_placed_stacked,
)
from repro_torch.core.graph import (
    BatchBanding,
    JointGraph,
    QueryStatic,
    batch_graphs,
    bucket_size,
    build_a_place_batch,
    build_graph,
    build_graph_skeleton,
    exact_banding_cached,
    merge_graph_batches,
    query_static,
    skeleton_cache_key,
)
from repro_torch.core.model import CostModelConfig, forward_ensemble
from repro_torch.serve.policy import DispatchPolicy, active_policy, resolve_policy
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


def graphs_to_device(g: JointGraph, device) -> JointGraph:
    """A host ``JointGraph`` of numpy arrays as contiguous tensors on ``device``
    (one asynchronous copy on a GPU: ``nn.arrays_to_device``)."""
    return JointGraph(*nn.arrays_to_device(list(g), device))


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
    n_hw: int,
    deferred: bool = False,
    chunk: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """All metrics' ensembles over one query's candidate placements, fused.

    One ``apply_gnn_placed_stacked`` call evaluates every (metric, member)
    pair with one kernel launch per GNN stage, on the trimmed active-slot
    layout; the raw ``(sum_E, B)`` block is split back per metric and voted.
    ``n_hw`` is the skeleton's real host count, which the caller reads off
    its host copy (reading it off ``skel`` would wait for the device).
    """
    if stacked.cfgs[0].traditional_mp:
        raise ValueError("traditional_mp models have no placed forward")
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
    ``policy``: a ``DispatchPolicy``; omitted, the host profile / env
    override resolves one (``serve.policy.resolve_policy``).
    ``device``: where every forward runs; None means ``"cuda"`` and raises
    when no GPU is present.
    Thread-safety: individual calls are safe to issue from one thread at a
    time; ``PlacementService`` adds the concurrent micro-batching front-end.
    """

    def __init__(
        self,
        models: Dict[str, Tuple[object, CostModelConfig]],
        meta=None,
        policy: Optional[DispatchPolicy] = None,
        device=None,
    ):
        self.device = nn.resolve_device(device, "CostEstimator")
        # plain dicts are copied (callers may mutate theirs); other Mappings
        # (bundle.LazyModels) pass through so laziness survives the facade
        self.models = dict(models) if type(models) is dict else models
        if not isinstance(self.models, Mapping):
            raise TypeError(f"models must be a mapping, got {type(models)}")
        self.meta = dict(meta or {})
        self.policy = (policy if policy is not None else resolve_policy()).validate()
        self._skeletons: "OrderedDict[Tuple, Tuple[JointGraph, JointGraph, QueryStatic]]" = OrderedDict()
        self._stacked: Dict[Tuple[str, ...], Optional[StackedEnsembles]] = {}
        # cross-query drain mixes: frozenset of structure keys -> (key ->
        # skeleton index, device skeleton stack, banding, max_parents)
        self._merged_groups: "OrderedDict[frozenset, Tuple]" = OrderedDict()
        self._params: Dict[str, object] = {}  # metric -> params on self.device
        self._optimizer = None
        # fault-injection / observation hooks (serve.chaos): objects with
        # optional ``before(kind, n)`` / ``after(kind, out) -> out | None``
        self._hooks: List[object] = []

    # -- hooks (the chaos-injection and observation seam) -------------------------

    def add_hook(self, hook) -> None:
        """Install a call hook.  ``before(kind, n)`` runs at dispatch time of
        every facade call (``kind`` in {"estimate", "score", "estimate_many",
        "score_many"}, ``n`` the row/graph count) and may raise or block —
        exactly what a real fault does.  ``after(kind, out)`` runs at
        finalize time (inside ``DeferredResult.result()`` for deferred
        calls) and may return a replacement output; the finiteness guard
        runs AFTER all hooks, so injected NaNs are caught like real ones."""
        self._hooks.append(hook)

    def remove_hook(self, hook) -> None:
        self._hooks.remove(hook)

    def _before(self, kind: str, n: int) -> None:
        for h in self._hooks:
            before = getattr(h, "before", None)
            if before is not None:
                before(kind, n)

    def _finish(self, kind: str, finalize, deferred: bool):
        """Wrap a finalize thunk with after-hooks + the finiteness guard."""

        def run():
            out = finalize()
            for h in self._hooks:
                after = getattr(h, "after", None)
                if after is not None:
                    repl = after(kind, out)
                    if repl is not None:
                        out = repl
            return _check_finite(kind, out)

        return _maybe_defer(run, deferred)

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
        self._before("estimate", int(g.op_x.shape[0]) if g.op_x.ndim == 3 else 1)
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

    def _skeleton_entry(self, query, cluster, key: Optional[Tuple] = None) -> Tuple[JointGraph, JointGraph, QueryStatic]:
        """Cached (host skeleton, device skeleton, QueryStatic) for one pair.

        The host copy feeds the merged path (stacking on the host before one
        device copy), the device copy the placed forwards.  ``key`` lets a
        caller that already computed ``skeleton_cache_key`` skip it."""
        if key is None:
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
            self._before("score", n)
            a_place = build_a_place_batch(query, cluster, assignments)
            pad = bucket_size(n) - n
            if pad:
                a_place = np.concatenate([a_place, np.repeat(a_place[-1:], pad, axis=0)])
            (a_place,) = nn.arrays_to_device([a_place], self.device)
            if stacked is not None:
                pending = placed_predict_fused(
                    stacked, skel, a_place, static, n_hw, deferred=True,
                    chunk=self.policy.score_chunk,
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

    # -- cross-query broadcast batches -------------------------------------------

    def supports_cross_query(self, metrics: Optional[Sequence[str]] = None) -> bool:
        """Whether ``metrics`` can ride one merged cross-query forward.

        Requires a fusable ensemble stack (shape-identical GNN configs) with
        the 3-stage structure (``traditional_mp`` models aggregate over
        rounds, not stages).  ``estimate_many`` / ``score_many`` fall back to
        per-request answers when this is False.
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        stacked = self._stacked_for(metrics)
        return stacked is not None and not stacked.cfgs[0].traditional_mp

    @staticmethod
    def _host_graphs(batch) -> JointGraph:
        """A batch as a numpy ``JointGraph`` with a batch axis (single graphs promoted)."""
        if not isinstance(batch, JointGraph):
            batch = batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in batch])
        g = JointGraph(*[np.asarray(x) for x in batch])
        return JointGraph(*[x[None] for x in g]) if g.op_x.ndim == 2 else g

    @staticmethod
    def _split_back(launched, stacked: StackedEnsembles, metrics, sizes) -> List[Dict[str, np.ndarray]]:
        """Per-chunk raw outputs -> votes, concatenated, then split per ``sizes``."""
        parts = [_split_votes(_host(raw), stacked) for raw in launched]
        merged = {m: np.concatenate([p[m] for p in parts]) for m in metrics}
        out, off = [], 0
        for size in sizes:
            out.append({m: merged[m][off : off + size] for m in metrics})
            off += size
        return out

    def _merged_forward(
        self,
        merged: JointGraph,
        sizes: Sequence[int],
        metrics: Tuple[str, ...],
        max_rows: Optional[int],
        deferred: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """One stacked forward per ``max_rows`` chunk of a merged host batch.

        Each chunk gets the signature-exact, row-trimmed banding of the
        structures it contains (``exact_banding_cached``), so stage-3 work
        tracks real rows: the fused ``sweep`` plan, one ``mp_sweep`` launch
        per chunk under ``use_pallas``.  Chunks are not bucket-padded: the
        forward runs eagerly, so a power-of-two row count would only add
        work.  Every chunk is queued on the device before any is read back;
        answers are split back per source batch.
        """
        stacked = self._stacked_for(metrics)
        total = int(merged.op_x.shape[0])
        step = max_rows if max_rows else total
        launched: List[torch.Tensor] = []
        for s in range(0, total, step):
            chunk = JointGraph(*[x[s : s + step] for x in merged])
            banding = exact_banding_cached(chunk)
            with torch.no_grad():
                launched.append(
                    forward_ensemble(stacked.params, graphs_to_device(chunk, self.device), stacked.cfgs[0], banding)
                )
        return _maybe_defer(lambda: self._split_back(launched, stacked, metrics, sizes), deferred)

    def estimate_many(
        self,
        batches: Sequence,
        metrics: Optional[Sequence[str]] = None,
        max_rows: Optional[int] = None,
        deferred: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """``estimate`` for N independent batches through ONE fused forward.

        ``batches`` entries are batched ``JointGraph``s (numpy; single graphs
        are promoted, empty batches allowed) or trace sequences; structures
        may differ freely, since every graph shares the canonical padded
        layout: the batches concatenate along the batch axis and one stacked
        forward per ``max_rows`` chunk answers everything.  Returns one
        metric -> predictions dict per input batch, order-aligned.
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        batches = list(batches)
        if not batches:
            return _maybe_defer(lambda: [], deferred)
        host = [self._host_graphs(b) for b in batches]
        if sum(int(g.op_x.shape[0]) for g in host) == 0:
            raise ValueError("no graphs to estimate")
        if not self.supports_cross_query(metrics):
            # heterogeneous configs: per-batch fallback, chunked like the
            # merged path; every chunk is queued before any is read back,
            # and the finiteness guard runs inside the delegated
            # ``estimate`` calls
            pendings: List[Optional[List[DeferredResult]]] = []
            for g in host:
                total = int(g.op_x.shape[0])
                if total == 0:  # filled in below with zero-width answers
                    pendings.append(None)
                    continue
                step = max_rows if max_rows else total
                pendings.append([
                    self.estimate(JointGraph(*[x[s : s + step] for x in g]), metrics, deferred=True)
                    for s in range(0, total, step)
                ])

            def finalize_fallback() -> List[Dict[str, np.ndarray]]:
                out: List[Optional[Dict[str, np.ndarray]]] = []
                for parts in pendings:
                    if parts is None:
                        out.append(None)
                        continue
                    done = [p.result() for p in parts]
                    out.append({m: np.concatenate([d[m] for d in done]) for m in metrics})
                template = next(o for o in out if o is not None)
                return [o if o is not None else {m: template[m][:0] for m in metrics} for o in out]

            return _maybe_defer(finalize_fallback, deferred)
        self._before("estimate_many", sum(int(g.op_x.shape[0]) for g in host))
        merged, sizes = merge_graph_batches(host)
        pending = self._merged_forward(merged, sizes, metrics, max_rows, deferred=True)
        return self._finish("estimate_many", pending.result, deferred)

    def score_many(
        self,
        requests: Sequence[Tuple],
        metrics: Optional[Sequence[str]] = None,
        max_rows: Optional[int] = None,
        keys: Optional[Sequence[Tuple]] = None,
        deferred: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """``score`` for N (query, cluster, assignments) requests through ONE
        fused forward.

        Requests are regrouped structure-major: each structure contributes
        its LRU-cached skeleton once plus all its candidate rows, and one
        stacked ``apply_gnn_merged`` forward per ``max_rows`` chunk scores
        every (metric, member, candidate) triple.  ``keys`` optionally
        carries precomputed ``skeleton_cache_key``s.  Returns one metric ->
        (N_i,) dict per request, order-aligned; answers equal per-request
        ``score`` to float tolerance (the same math in another association
        order).
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        requests = list(requests)
        if not requests:
            return _maybe_defer(lambda: [], deferred)
        if not self.supports_cross_query(metrics):
            # the finiteness guard runs inside the delegated ``score`` calls
            per_req = [self.score(q, c, a, metrics, deferred=True) for q, c, a in requests]
            return _maybe_defer(lambda: [p.result() for p in per_req], deferred)
        stacked = self._stacked_for(metrics)
        if keys is None:
            keys = [skeleton_cache_key(q, c) for q, c, _ in requests]

        # regroup structure-major: one skeleton + one concatenated candidate
        # block per structure; remember each request's slice for the split
        groups: "OrderedDict[Tuple, List[int]]" = OrderedDict()
        mats = []
        for i, (q, c, a) in enumerate(requests):
            a = np.asarray(a, dtype=np.int64)
            if len(a) == 0:
                raise ValueError("no candidates to score")
            mats.append(a)
            groups.setdefault(keys[i], []).append(i)
        self._before("score_many", sum(len(a) for a in mats))

        index_of, skels_dev, banding, max_parents = self._merged_group_for(requests, groups)
        blocks, ids = [], []
        for key, idxs in groups.items():
            q, c, _ = requests[idxs[0]]
            block = build_a_place_batch(q, c, np.concatenate([mats[i] for i in idxs]))
            blocks.append(block)
            ids.append(np.full(len(block), index_of[key], dtype=np.int64))
        pending = self._merged_placements_forward(
            skels_dev, banding, max_parents, np.concatenate(ids), np.concatenate(blocks),
            [len(b) for b in blocks], stacked, metrics, max_rows, deferred=True,
        )

        def finalize() -> List[Dict[str, np.ndarray]]:
            # split each structure's block back onto its requests, in order
            out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(requests)
            for g_out, idxs in zip(pending.result(), groups.values()):
                off = 0
                for i in idxs:
                    n = len(mats[i])
                    out[i] = {m: g_out[m][off : off + n] for m in metrics}
                    off += n
            return out

        return self._finish("score_many", finalize, deferred)

    def _merged_group_for(self, requests, groups) -> Tuple:
        """(key -> skeleton index, device skeleton stack, banding,
        max_parents) for one drain mix.

        Keyed on the *set* of structure keys (drains of one recurring mix may
        arrive in any order, so the index mapping is part of the entry); the
        mix pays stacking, banding, the in-degree check and the skeleton
        device copy once, in an LRU of ``policy.merged_group_cache_size``.
        """
        mix_key = frozenset(groups)
        hit = self._merged_groups.get(mix_key)
        if hit is not None:
            self._merged_groups.move_to_end(mix_key)
            return hit
        index_of = {key: i for i, key in enumerate(groups)}
        skels = batch_graphs(
            [self._skeleton_entry(*requests[idxs[0]][:2], key)[0] for key, idxs in groups.items()]
        )
        banding = exact_banding_cached(skels)
        max_parents = int(np.asarray(skels.a_flow).sum(axis=-2).max(initial=1))
        entry = (index_of, graphs_to_device(skels, self.device), banding, max_parents)
        self._merged_groups[mix_key] = entry
        while len(self._merged_groups) > self.policy.merged_group_cache_size:
            self._merged_groups.popitem(last=False)
        return entry

    def _merged_placements_forward(
        self,
        skels_dev: JointGraph,
        banding: BatchBanding,
        max_parents: int,
        skel_id: np.ndarray,
        a_place: np.ndarray,
        sizes: Sequence[int],
        stacked: StackedEnsembles,
        metrics: Tuple[str, ...],
        max_rows: Optional[int],
        deferred: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """Chunked ``apply_gnn_merged`` over a structure-major placement batch.

        The rows go to the device in one copy; each ``max_rows`` chunk (not
        bucket-padded, as in ``_merged_forward``) is queued on the device
        before any is read back.
        """
        total = int(a_place.shape[0])
        step = max_rows if max_rows else total
        skel_id_dev, a_place_dev = nn.arrays_to_device([skel_id, a_place], self.device)
        launched: List[torch.Tensor] = []
        for s in range(0, total, step):
            with torch.no_grad():
                launched.append(apply_gnn_merged(
                    stacked.params, skels_dev, skel_id_dev[s : s + step], a_place_dev[s : s + step],
                    stacked.cfgs[0].gnn, banding, max_parents,
                ))
        return _maybe_defer(lambda: self._split_back(launched, stacked, metrics, sizes), deferred)

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
