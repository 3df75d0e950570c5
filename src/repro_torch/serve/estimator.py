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
  skeleton stack of a set of structures, its banding and its parent bound,
  and on a GPU the stack's constants of the merged forward and the CUDA
  graphs that replay it (``serve/graphs.py``), one per stacked ensemble and
  row bucket, captured on first sight into one memory pool.

PyTorch runs eagerly, so the JAX package's trace caches have no counterpart,
and buffer donation none either (PyTorch frees a chunk's inputs when the last
reference goes).  ``deferred=True`` returns a ``DeferredResult`` once the
forward is queued on the device, before the results reach the host; on a GPU
that dispatch half waits for nothing on the host (host arrays reach the
device through one page-locked buffer and a ``non_blocking`` copy,
``nn.arrays_to_device``; ``estimate_many`` writes its batches straight into
that buffer, ``stage_graph_batches``), and it queues each forward's
readback right behind that forward on the same stream: a ``non_blocking``
copy into a page-locked host tensor and an event (``_queue_host``).  ``result()`` then waits on that
event, so it waits for the call's own kernels and never for work launched
after the call, and the device runs the next call while the host votes on
this one.  ``PlacementService`` launches one drain while the device still
runs the previous one.  ``add_hook`` is the fault-injection
and observation seam (``serve/chaos.py``): ``before`` at dispatch, ``after``
at finalize, ahead of the finiteness guard.

Every facade call opens spans (``repro_torch.obs``) while ``torch.profiler``
records: a root ``estimator.<entry>`` over the dispatch half, whose call id
the deferred ``estimator.finalize`` carries, and inside them the host work
(``host.*``), the copies to the device (``h2d.stage``), the forward's launch
(``gnn.forward``, with its stage-3 row counts), the wait for the readback
(``d2h.wait``; on a GPU with ``ready``, whether it had landed already) and the
vote (``host.vote``).  The skeleton, merged-group and banding caches count
their hits and misses (``cache.*``), as does the merged forward's graph
cache (``cache.graph.*``; the ``gnn.forward`` span's ``graph`` attribute says
how a chunk ran), and on a GPU each readback counts ``d2h.ready`` or
``d2h.blocked``.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn, obs
from repro_torch.core.gnn import (
    MergedConstants,
    apply_gnn_merged,
    apply_gnn_placed_members,
    apply_gnn_placed_stacked,
    merged_constants,
)
from repro_torch.core.graph import (
    BatchBanding,
    JointGraph,
    QueryStatic,
    batch_graphs,
    bucket_size,
    build_a_place_batch,
    build_graph,
    build_graph_batch,
    build_graph_skeleton,
    exact_banding_cached,
    exact_banding_lookup,
    merge_graph_batches,
    pad_batch,
    query_static,
    skeleton_cache_key,
)
from repro_torch.core.model import CostModelConfig, forward_ensemble
from repro_torch.serve.graphs import MergedGraph, row_bucket
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

    ``result()`` waits for the readback queued at dispatch (on the CPU: copies
    the values now) and runs the remaining host work (vote, split per metric).
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


class _Readback(NamedTuple):
    """A device tensor's copy to page-locked host memory, queued on its stream,
    and the event recorded right after it."""

    host: torch.Tensor
    done: torch.cuda.Event


def _queue_host(raw: torch.Tensor, cols: Optional[int] = None):
    """``raw``'s readback, queued now: on a GPU a ``non_blocking`` copy into a
    page-locked host tensor behind the kernels that make ``raw``, and an event
    after it; on the CPU ``raw`` itself, copied when ``_host`` reads it.
    ``cols`` keeps the first ``cols`` entries of the last axis (a padded
    forward's real rows): ``raw`` is copied whole, then viewed."""
    if raw.device.type != "cuda":
        return raw if cols is None else raw[..., :cols]
    host = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
    host.copy_(raw, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(raw.device))
    return _Readback(host if cols is None else host[..., :cols], done)


def _host(raw) -> np.ndarray:
    """The values of a device tensor, or of a ``_Readback``, as a host array.
    A readback waits for its own event only, and counts whether it had
    landed already (``d2h.ready``) or not (``d2h.blocked``)."""
    with obs.span("d2h.wait") as sp:
        if isinstance(raw, _Readback):
            ready = raw.done.query()
            obs.count("d2h.ready" if ready else "d2h.blocked")
            raw.done.synchronize()
            if sp.on:
                sp.set(bytes=raw.host.nbytes, ready=int(ready))
            return raw.host.numpy()
        if sp.on:
            sp.set(bytes=raw.numel() * raw.element_size())
        return raw.detach().cpu().numpy()


def _real3(op_mask, op_depth) -> int:
    """Real operator rows at depth 1 or more of a host batch, each once: the rows
    stage 3 has to update."""
    return int(np.count_nonzero((np.asarray(op_mask) > 0) & (np.asarray(op_depth) >= 1)))


def _level_rows(banding: BatchBanding) -> int:
    """Rows one graph's stage-3 levels cover under ``banding``: the sum of the spans."""
    return sum(e - s for _, (s, e), _ in banding.levels)


class _MergedGroup(NamedTuple):
    """A drain mix's entry in the merged-group LRU (``_merged_group_for``)."""

    index_of: Dict  # structure key -> skeleton index
    skels: JointGraph  # the skeleton stack on the device
    banding: BatchBanding
    max_parents: int
    real3: np.ndarray  # real rows at depth >= 1 per skeleton
    consts: Optional[MergedConstants]  # on a GPU: the stack's constants of the merged forward
    graphs: Dict[Tuple[int, int], MergedGraph]  # (id of the stacked ensemble, row bucket) -> graph


def graphs_to_device(g: JointGraph, device) -> JointGraph:
    """A host ``JointGraph`` of numpy arrays as contiguous tensors on ``device``
    (one asynchronous copy on a GPU: ``nn.arrays_to_device``)."""
    return JointGraph(*nn.arrays_to_device(list(g), device))


def stage_graph_batches(batches: Sequence[JointGraph], device) -> Tuple[JointGraph, JointGraph]:
    """Host batches joined along the batch axis, on the host and on ``device``:
    each field's batches are written straight into one staging buffer
    (``nn.parts_to_device``), so the bytes are copied once, where
    ``merge_graph_batches`` then ``graphs_to_device`` copy them twice.  The
    host graphs are views of that buffer, and equal ``merge_graph_batches``'s."""
    host, dev = nn.parts_to_device([[getattr(b, f) for b in batches] for f in JointGraph._fields], device)
    return JointGraph(*host), JointGraph(*dev)


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
    raw = _queue_host(raw)
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
        # cross-query drain mixes: frozenset of structure keys -> their entry
        self._merged_groups: "OrderedDict[frozenset, _MergedGroup]" = OrderedDict()
        self._graph_pool = None  # the one memory pool of the merged forward's CUDA graphs
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
        """Wrap a finalize thunk with after-hooks + the finiteness guard; its
        span joins the dispatch half's call id, and the hooks and the guard,
        host work on the answers, count as ``host.vote``."""
        call = obs.current_call()

        def run():
            with obs.span("estimator.finalize", call=call):
                out = finalize()
                with obs.span("host.vote"):
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

    @staticmethod
    def _featurize(traces) -> JointGraph:
        """A sequence of traces featurized into one batched host ``JointGraph``."""
        with obs.span("host.featurize"):
            return batch_graphs([build_graph(t.query, t.cluster, t.placement) for t in traces])

    def _as_graphs(self, batch) -> JointGraph:
        """A batched ``JointGraph``, or a sequence of traces to featurize, on the device."""
        return graphs_to_device(batch if isinstance(batch, JointGraph) else self._featurize(batch), self.device)

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
        with obs.span("estimator.estimate") as sp:
            host = batch if isinstance(batch, JointGraph) else self._featurize(batch)
            g = graphs_to_device(host, self.device)
            n = int(g.op_x.shape[0]) if g.op_x.ndim == 3 else 1
            sp.set(n=n)
            self._before("estimate", n)
            stacked = self._stacked_for(metrics)
            with torch.no_grad(), obs.span("gnn.forward") as fw:
                if stacked is None:  # mixed architectures: per-metric forwards, shared batch
                    raws = {m: forward_ensemble(self._params_for(m), g, self.models[m][1]) for m in metrics}
                else:
                    if fw.on and not stacked.cfgs[0].traditional_mp:  # the full-depth scan: every level, every row
                        fw.set(rows3=stacked.cfgs[0].gnn.max_depth * int(np.size(host.op_mask)),
                               real3=_real3(host.op_mask, host.op_depth))
                    raw = forward_ensemble(stacked.params, g, stacked.cfgs[0])
            if stacked is None:
                raws = {m: _queue_host(r) for m, r in raws.items()}
                return self._finish(
                    "estimate",
                    lambda: {m: _ensemble_vote(_host(raws[m]), self.models[m][1]) for m in metrics},
                    deferred,
                )
            raw = _queue_host(raw)
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
            obs.count("cache.skeleton.hit")
            self._skeletons.move_to_end(key)
            return hit
        obs.count("cache.skeleton.miss")
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
        ``DeferredResult``.  ``traditional_mp`` models lack the 3-stage
        structure the placed forward exploits: they score the full broadcast
        batch through ``estimate``.
        """
        metrics = tuple(metrics)
        if any(self.models[m][1].traditional_mp for m in metrics):

            def score_generic(assignments: np.ndarray) -> Dict[str, np.ndarray]:
                n = len(assignments)
                if n == 0:
                    raise ValueError("no candidates to score")
                graphs = pad_batch(build_graph_batch(query, cluster, assignments), bucket_size(n))
                # hooks and the finiteness guard fire inside the delegated
                # ``estimate`` (kind "estimate"), not a second time here
                pending = self.estimate(graphs, metrics, deferred=True)
                return _maybe_defer(lambda: {m: v[:n] for m, v in pending.result().items()}, deferred)

            return score_generic
        host, skel, static = self._skeleton_entry(query, cluster)
        n_hw = int(host.hw_mask.sum())
        stacked = self._stacked_for(metrics)

        def score(assignments: np.ndarray) -> Dict[str, np.ndarray]:
            n = len(assignments)
            with obs.span("estimator.score", n=n):
                if n == 0:
                    raise ValueError("no candidates to score")
                self._before("score", n)
                with obs.span("host.a_place", rows=n):
                    a_place = build_a_place_batch(query, cluster, assignments)
                    pad = bucket_size(n) - n
                    if pad:
                        a_place = np.concatenate([a_place, np.repeat(a_place[-1:], pad, axis=0)])
                (a_place,) = nn.arrays_to_device([a_place], self.device)
                if stacked is not None:
                    with obs.span("gnn.forward") as fw:
                        if fw.on:  # the exact plan: each level covers just its operators
                            per_row = sum(len(level) for level in static.updates)
                            fw.set(rows3=int(a_place.shape[0]) * per_row, real3=n * per_row)
                        pending = placed_predict_fused(
                            stacked, skel, a_place, static, n_hw, deferred=True,
                            chunk=self.policy.score_chunk,
                        )
                    return self._finish(
                        "score", lambda: {m: v[:n] for m, v in pending.result().items()}, deferred
                    )
                # heterogeneous (non-fusable) configs: per-metric loop
                with obs.span("gnn.forward"):
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

    @classmethod
    def _host_graphs(cls, batch) -> JointGraph:
        """A batch as a numpy ``JointGraph`` with a batch axis (single graphs promoted)."""
        if not isinstance(batch, JointGraph):
            batch = cls._featurize(batch)
        g = JointGraph(*[np.asarray(x) for x in batch])
        return JointGraph(*[x[None] for x in g]) if g.op_x.ndim == 2 else g

    @staticmethod
    def _split_back(launched, stacked: StackedEnsembles, metrics, sizes) -> List[Dict[str, np.ndarray]]:
        """Per-chunk raw outputs -> votes, concatenated, then split per ``sizes``."""
        parts = [_split_votes(_host(raw), stacked) for raw in launched]
        with obs.span("host.vote"):
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
        dev: Optional[JointGraph] = None,
    ) -> List[Dict[str, np.ndarray]]:
        """One stacked forward per ``max_rows`` chunk of a merged host batch.

        Each chunk gets the signature-exact, row-trimmed banding of the
        structures it contains (``exact_banding_cached``), so stage-3 work
        tracks real rows: the fused ``sweep`` plan, one ``mp_sweep`` launch
        per chunk under ``use_pallas``.  Chunks are not bucket-padded: the
        forward runs eagerly, so a power-of-two row count would only add
        work.  Every chunk, with its readback right behind it, is queued on
        the device before the host waits on any; answers are split back per
        source batch.  ``dev``, the merged batch already on the device
        (``stage_graph_batches``), is sliced per chunk; without it each chunk
        is copied to the device on its own.
        """
        stacked = self._stacked_for(metrics)
        total = int(merged.op_x.shape[0])
        step = max_rows if max_rows else total
        launched = []  # each chunk's readback (``_queue_host``)
        for s in range(0, total, step):
            chunk = JointGraph(*[x[s : s + step] for x in merged])
            with obs.span("host.banding") as sp:
                banding, hit = exact_banding_lookup(chunk)
                sp.set(hit=hit)
            g = graphs_to_device(chunk, self.device) if dev is None else JointGraph(*[x[s : s + step] for x in dev])
            with torch.no_grad(), obs.span("gnn.forward") as fw:
                if fw.on:  # the banded plan: each level covers its span, in every graph
                    fw.set(rows3=int(chunk.op_x.shape[0]) * _level_rows(banding),
                           real3=_real3(chunk.op_mask, chunk.op_depth))
                raw = forward_ensemble(stacked.params, g, stacked.cfgs[0], banding)
            launched.append(_queue_host(raw))
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
        with obs.span("estimator.estimate_many") as sp:
            return self._estimate_many(batches, metrics, max_rows, deferred, sp)

    def _estimate_many(self, batches, metrics, max_rows, deferred, sp):
        """``estimate_many``'s body, inside its root span ``sp``."""
        with obs.span("host.merge") as mg:
            host = [self._host_graphs(b) for b in batches]
            sizes = tuple(int(g.op_x.shape[0]) for g in host)
            n = sum(sizes)
            cross = n > 0 and self.supports_cross_query(metrics)
            if cross and self.device.type == "cpu":  # each chunk's tensors are views of these arrays
                merged, dev = merge_graph_batches(host).graphs, None
            mg.set(graphs=n)
        sp.set(n=n)
        if n == 0:
            raise ValueError("no graphs to estimate")
        if not cross:
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
        self._before("estimate_many", n)
        if self.device.type != "cpu":  # one copy on the host, straight into the staging buffer
            merged, dev = stage_graph_batches(host, self.device)
        pending = self._merged_forward(merged, sizes, metrics, max_rows, deferred=True, dev=dev)
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
        with obs.span("estimator.score_many") as sp:
            if not self.supports_cross_query(metrics):
                # the finiteness guard runs inside the delegated ``score`` calls
                per_req = [self.score(q, c, a, metrics, deferred=True) for q, c, a in requests]
                return _maybe_defer(lambda: [p.result() for p in per_req], deferred)
            return self._score_many(requests, metrics, max_rows, keys, deferred, sp)

    def _score_many(self, requests, metrics, max_rows, keys, deferred, sp):
        """``score_many``'s merged path, inside its root span ``sp``."""
        stacked = self._stacked_for(metrics)
        with obs.span("host.keys", requests=len(requests)):
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
        n = sum(len(a) for a in mats)
        sp.set(n=n)
        self._before("score_many", n)

        group = self._merged_group_for(requests, groups)
        with obs.span("host.a_place", rows=n):
            blocks, ids = [], []
            for key, idxs in groups.items():
                q, c, _ = requests[idxs[0]]
                block = build_a_place_batch(q, c, np.concatenate([mats[i] for i in idxs]))
                blocks.append(block)
                ids.append(np.full(len(block), group.index_of[key], dtype=np.int64))
            skel_id, a_place = np.concatenate(ids), np.concatenate(blocks)
        pending = self._merged_placements_forward(
            group, skel_id, a_place, [len(b) for b in blocks], stacked, metrics, max_rows, deferred=True,
        )

        def finalize() -> List[Dict[str, np.ndarray]]:
            # split each structure's block back onto its requests, in order
            parts = pending.result()
            with obs.span("host.vote"):
                out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(requests)
                for g_out, idxs in zip(parts, groups.values()):
                    off = 0
                    for i in idxs:
                        n = len(mats[i])
                        out[i] = {m: g_out[m][off : off + n] for m in metrics}
                        off += n
                return out

        return self._finish("score_many", finalize, deferred)

    def _merged_group_for(self, requests, groups) -> _MergedGroup:
        """One drain mix's entry: key -> skeleton index, the device skeleton
        stack, its banding, max_parents, the real rows at depth >= 1 per
        skeleton, and on a GPU the stack's constants of the merged forward
        and its CUDA graphs (none yet).

        Keyed on the *set* of structure keys (drains of one recurring mix may
        arrive in any order, so the index mapping is part of the entry); the
        mix pays stacking, banding, the in-degree check, the skeleton device
        copy and the constants once, in an LRU of
        ``policy.merged_group_cache_size``, whose evictions drop the graphs.
        """
        with obs.span("host.group") as sp:
            mix_key = frozenset(groups)
            hit = self._merged_groups.get(mix_key)
            sp.set(hit=hit is not None)
            if hit is not None:
                obs.count("cache.group.hit")
                self._merged_groups.move_to_end(mix_key)
                return hit
            obs.count("cache.group.miss")
            index_of = {key: i for i, key in enumerate(groups)}
            skels = batch_graphs(
                [self._skeleton_entry(*requests[idxs[0]][:2], key)[0] for key, idxs in groups.items()]
            )
            banding = exact_banding_cached(skels)
            max_parents = int(np.asarray(skels.a_flow).sum(axis=-2).max(initial=1))
            real3 = np.count_nonzero((np.asarray(skels.op_mask) > 0) & (np.asarray(skels.op_depth) >= 1), axis=-1)
            skels_dev = graphs_to_device(skels, self.device)
            consts = merged_constants(skels_dev, banding, max_parents) if self.device.type == "cuda" else None
            entry = _MergedGroup(index_of, skels_dev, banding, max_parents, real3, consts, {})
            self._merged_groups[mix_key] = entry
            while len(self._merged_groups) > self.policy.merged_group_cache_size:
                self._merged_groups.popitem(last=False)
            return entry

    def _merged_placements_forward(
        self,
        group: _MergedGroup,
        skel_id: np.ndarray,
        a_place: np.ndarray,
        sizes: Sequence[int],
        stacked: StackedEnsembles,
        metrics: Tuple[str, ...],
        max_rows: Optional[int],
        deferred: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """The merged forward over a structure-major placement batch, one per
        ``max_rows`` chunk, each queued on the device with its readback right
        behind it before the host waits on any.

        On a GPU each chunk runs at its row bucket (``graphs.row_bucket``):
        its rows, padded, go to the static inputs of the group's graph for
        this ensemble and bucket in one copy, and the graph is replayed
        (captured on first sight; ``graphs.MergedGraph``); only the real
        rows are read back.  On the CPU the rows go to the device in one
        copy and each chunk runs ``apply_gnn_merged`` unpadded.
        """
        total = int(a_place.shape[0])
        step = max_rows if max_rows else total
        if group.consts is None:
            skel_id_dev, a_place_dev = nn.arrays_to_device([skel_id, a_place], self.device)
        launched = []  # each chunk's readback (``_queue_host``)
        for s in range(0, total, step):
            rows = skel_id[s : s + step]
            graph = None
            if group.consts is not None:
                graph = self._merged_graph(group, stacked, row_bucket(len(rows)), a_place.shape[1:])
                graph.stage(rows, a_place[s : s + step])
            with torch.no_grad(), obs.span("gnn.forward") as fw:
                if graph is not None:
                    raw, how = graph.run(self._graph_pool)
                else:
                    how = "eager"
                    raw = apply_gnn_merged(
                        stacked.params, group.skels, skel_id_dev[s : s + step], a_place_dev[s : s + step],
                        stacked.cfgs[0].gnn, group.banding, group.max_parents,
                    )
                if fw.on:  # the banded plan over the skeletons' rows, pad rows included
                    fw.set(rows3=int(raw.shape[-1]) * _level_rows(group.banding),
                           real3=int(group.real3[rows].sum()), graph=how)
            launched.append(_queue_host(raw, len(rows)))
        return _maybe_defer(lambda: self._split_back(launched, stacked, metrics, sizes), deferred)

    def _merged_graph(self, group: _MergedGroup, stacked: StackedEnsembles, rows: int, place_shape) -> MergedGraph:
        """The group's graph for ``stacked`` at ``rows``, made on first sight
        (``cache.graph.miss``; its first run captures it).  A graph is keyed
        on the stacked ensemble object it reads, so a new stack never replays
        an old one's weights; making one drops the group's graphs of stacks
        the estimator no longer holds."""
        key = (id(stacked), rows)  # the graph holds ``stacked``, so its id stays unique
        graph = group.graphs.get(key)
        if graph is not None:
            return graph
        obs.count("cache.graph.miss")
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        live = {id(x) for x in self._stacked.values() if x is not None}
        for k in [k for k, g in group.graphs.items() if id(g.stacked) not in live]:
            del group.graphs[k]
        graph = group.graphs[key] = MergedGraph(stacked, group.consts, rows, tuple(place_shape), self.device)
        return graph

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
