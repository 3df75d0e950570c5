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
* the per-metrics-tuple **stack cache** (``_stacks_for``): the requested
  metrics' ensembles stacked along the member axis on the device, in one
  stack when their configs match (one forward a chunk, one kernel launch
  per stage), else in one stack per metric;
* the per-drain-mix **merged-group LRU** of ``score_many``: the device
  skeleton stack of a set of structures, its banding and its parent bound,
  and on a GPU the stack's constants of the merged forward and the CUDA
  graphs that replay it (``serve/graphs.py``), one per stacked ensemble and
  row bucket, captured on first sight into one memory pool.

Every entry answers through one launch path.  Its rows go in chunks (one
for ``estimate`` and ``score``, ``max_rows`` wide for ``estimate_many`` and
``score_many``); each chunk's forward runs against each stack and its
readback is queued right behind it (``_launch``).  One finalize
(``_collect``) then waits on the readbacks, votes each stack, joins the
chunks and splits the answers per request.  A ``traditional_mp`` model has
no placed or merged placed forward: ``score`` runs it through ``estimate``
on the broadcast batch, ``score_many`` per request.

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
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn, obs
from repro_torch.core.gnn import (
    MergedConstants,
    apply_gnn_merged,
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
from repro_torch.serve.graphs import ForwardGraph, merged_graph, padded_parts, row_bucket, zero_padded
from repro_torch.serve.policy import DispatchPolicy, resolve_policy
from repro_torch.serve.stacking import StackedEnsembles, _split_votes, stack_metric_models

ESTIMATE_GRAPHS = 16  # ``estimate``'s CUDA graphs an estimator keeps, the least recently used dropped first


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
    graphs: Dict[Tuple[int, int], ForwardGraph]  # (id of the stacked ensemble, row bucket) -> graph


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
# The numeric cores behind the facade methods, and the chunks of the one launch
# path (``CostEstimator._launch``); ``params`` and the graphs must already be on
# one device.


def ensemble_proba(params, g: JointGraph, cfg: CostModelConfig) -> np.ndarray:
    """Mean over members of the per-member sigmoid probability."""
    if cfg.task != "classification":
        raise ValueError(f"proba needs a classification metric, not {cfg.metric!r}")
    with torch.no_grad():
        raw = _host(forward_ensemble(params, g, cfg))
    return (1.0 / (1.0 + np.exp(-raw))).mean(axis=0)


class _GraphChunk(NamedTuple):
    """Graphs of an ``estimate`` or ``estimate_many`` chunk."""

    host: JointGraph  # numpy
    dev: Optional[JointGraph]  # on the device; None when the chunk replays ``graphs``
    banding: Optional[BatchBanding]  # None: the full-depth scan
    graphs: Tuple[ForwardGraph, ...] = ()  # ``estimate`` of a batch on a GPU: per stack, its graph, the batch staged


def _scan_forward(stacked: StackedEnsembles, static) -> torch.Tensor:
    """``estimate``'s graph forward: the full-depth scan over the static
    ``JointGraph``, through this module's ``forward_ensemble`` as it stands
    when the forward runs."""
    return forward_ensemble(stacked.params, JointGraph(*static), stacked.cfgs[0], None)


def _graph_forward(chunk: _GraphChunk, i: int, stack: StackedEnsembles, fw):
    """A graph chunk's forward over ``stack`` -> (raw, its real columns): on
    a GPU a batch's graph replayed (captured on first sight), else
    ``forward_ensemble`` eagerly."""
    cfg = stack.cfgs[0]
    graph = chunk.graphs[i] if chunk.graphs else None
    if graph is not None:
        raw, how = graph.run()
    else:
        raw, how = forward_ensemble(stack.params, chunk.dev, cfg, chunk.banding), "eager"
    if fw.on:
        host = chunk.host
        if not cfg.traditional_mp:
            if chunk.banding is None:  # the full-depth scan: every level, every row, pad graphs included
                rows = int(np.size(host.op_mask)) if graph is None else graph.rows * int(host.op_mask.shape[-1])
                rows3 = cfg.gnn.max_depth * rows
            else:  # the banded plan: each level covers its span, in every graph
                rows3 = int(host.op_x.shape[0]) * _level_rows(chunk.banding)
            fw.set(rows3=rows3, real3=_real3(host.op_mask, host.op_depth))
        fw.set(graph=how)
    return raw, None if graph is None else len(chunk.host.op_x)


class _PlacedChunk(NamedTuple):
    """Rows of a ``score_many`` chunk: on a GPU staged into each stack's graph,
    on the CPU as device slices."""

    group: _MergedGroup
    rows: np.ndarray  # each row's skeleton index, on the host
    graphs: Tuple[ForwardGraph, ...]  # on a GPU, per stack: its graph, the rows staged
    skel_id: Optional[torch.Tensor] = None  # on the CPU
    a_place: Optional[torch.Tensor] = None


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
        self._stacks: Dict[Tuple[str, ...], Tuple[StackedEnsembles, ...]] = {}
        # cross-query drain mixes: frozenset of structure keys -> their entry
        self._merged_groups: "OrderedDict[frozenset, _MergedGroup]" = OrderedDict()
        # on a GPU, ``estimate``'s graphs: (id of the stacked ensemble, row bucket, layout) -> graph
        self._estimate_graphs: "OrderedDict[Tuple, ForwardGraph]" = OrderedDict()
        self._graph_pool = None  # the one memory pool of every CUDA graph (``serve/graphs.py``)
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
        device once and is one chunk: one forward per stack, on the
        full-depth scan plan; on a GPU a batch runs at its row bucket by
        replaying a CUDA graph per stack (``_scan_chunk``).  Returns metric ->
        predictions aligned with the batch (0-d for a single graph).
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        with obs.span("estimator.estimate") as sp:
            host = batch if isinstance(batch, JointGraph) else self._featurize(batch)
            n = int(np.shape(host.op_x)[0]) if np.ndim(host.op_x) == 3 else 1
            sp.set(n=n)
            self._before("estimate", n)
            stacks = self._stacks_for(metrics)
            launched = self._launch(stacks, n, None, lambda s, e: self._scan_chunk(host, stacks), _graph_forward)
            return self._finish("estimate", lambda: self._collect(stacks, launched), deferred)

    def _scan_chunk(self, host: JointGraph, stacks: Sequence[StackedEnsembles]) -> _GraphChunk:
        """``estimate``'s one chunk.  On a GPU a batch of ``B`` graphs runs at
        ``row_bucket(B)`` graphs, padded with zero graphs, by replaying each
        stack's graph (``_estimate_graph``): the batch is staged straight into
        the first graph's static inputs in one copy, and the other stacks'
        graphs copy it from there on the device.  On the CPU, and for a
        single graph, the batch goes to the device as it is."""
        if self.device.type != "cuda" or np.ndim(host.op_x) != 3:
            return _GraphChunk(host, graphs_to_device(host, self.device), None)
        host = JointGraph(*[np.asarray(x) for x in host])
        rows = row_bucket(len(host.op_x))
        graphs = tuple(self._estimate_graph(st, rows, host) for st in stacks)
        graphs[0].stage(zero_padded(host, rows))
        for graph in graphs[1:]:
            graph.buf.copy_(graphs[0].buf)
        return _GraphChunk(host, None, None, graphs)

    def _estimate_graph(self, stacked: StackedEnsembles, rows: int, host: JointGraph) -> ForwardGraph:
        """``estimate``'s graph for ``stacked`` at ``rows`` graphs of ``host``'s
        layout (each field's dtype and per-graph shape), made on first sight
        and kept in an LRU of ``ESTIMATE_GRAPHS``."""
        layout = tuple((x.dtype.str, x.shape[1:]) for x in host)
        key = (id(stacked), rows, layout)
        graph = self._graph_in(self._estimate_graphs, key, lambda pool: ForwardGraph(
            stacked, rows, [(x.dtype, (rows, *x.shape[1:])) for x in host], self.device, _scan_forward, pool))
        self._estimate_graphs.move_to_end(key)
        while len(self._estimate_graphs) > ESTIMATE_GRAPHS:
            self._estimate_graphs.popitem(last=False)
        return graph

    def _graph_in(self, graphs: Dict, key: Tuple, make: Callable) -> ForwardGraph:
        """``graphs[key]``, made by ``make(pool)`` on first sight
        (``cache.graph.miss``; its first run captures it into the one pool).
        A graph is keyed on the id of the stacked ensemble object it reads,
        and holds that object, so the id stays unique and a new stack never
        replays an old one's weights; making one drops the graphs in
        ``graphs`` of stacks the estimator no longer holds."""
        graph = graphs.get(key)
        if graph is not None:
            return graph
        obs.count("cache.graph.miss")
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        live = {id(st) for stacks in self._stacks.values() for st in stacks}
        for k in [k for k, g in graphs.items() if id(g.stacked) not in live]:
            del graphs[k]
        graph = graphs[key] = make(self._graph_pool)
        return graph

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

    def _stacks_for(self, metrics: Tuple[str, ...]) -> Tuple[StackedEnsembles, ...]:
        """The ensemble stacks that answer ``metrics``, on the device, cached per
        metrics tuple: one stack when the metrics' configs match, else one
        single-metric stack per metric, in ``metrics`` order."""
        stacks = self._stacks.get(metrics)
        if stacks is None:
            try:
                stacks = (stack_metric_models(self.models, metrics),)
            except ValueError:  # differing configs (or no metric)
                stacks = tuple(stack_metric_models(self.models, (m,)) for m in metrics)
            stacks = self._stacks[metrics] = tuple(
                st._replace(params=nn.to_device(st.params, self.device)) for st in stacks
            )
        return stacks

    def _launch(
        self,
        stacks: Sequence[StackedEnsembles],
        total: int,
        max_rows: Optional[int],
        prepare: Callable,
        forward: Callable,
    ) -> List[List]:
        """The one launch path: rows ``[0, total)`` in ``max_rows`` chunks (one
        chunk when None), each made on the host by ``prepare(start, stop)``,
        then run against every stack: ``forward(chunk, i, stacks[i], fw)``
        launches the forward inside its ``gnn.forward`` span ``fw`` (setting
        the span's attributes while it records) and returns the raw ``(E, B)``
        output and its real columns (None: all), whose readback is queued
        right behind it.  Every chunk is queued before the host waits on
        any.  Returns the readbacks, per chunk, per stack (``_collect``)."""
        step = max_rows or max(total, 1)
        launched = []
        for s in range(0, max(total, 1), step):
            chunk = prepare(s, min(s + step, total))
            row = []
            for i, stack in enumerate(stacks):
                with torch.no_grad(), obs.span("gnn.forward") as fw:
                    raw, cols = forward(chunk, i, stack, fw)
                row.append(_queue_host(raw, cols))
            launched.append(row)
        return launched

    @staticmethod
    def _collect(stacks, launched, sizes: Optional[Sequence[int]] = None):
        """The one finalize: waits on each readback, votes it per stack, and
        with ``sizes`` joins the chunks and splits them into one metric ->
        answers dict per request; without, the one chunk's dict."""
        parts = []
        for row in launched:
            votes = {}
            for raw, stack in zip(row, stacks):
                votes.update(_split_votes(_host(raw), stack))
            parts.append(votes)
        if sizes is None:
            (out,) = parts
            return out
        with obs.span("host.vote"):
            joined = {m: np.concatenate([p[m] for p in parts]) for m in parts[0]}
            out, off = [], 0
            for size in sizes:
                out.append({m: v[off : off + size] for m, v in joined.items()})
                off += size
            return out

    def scorer(self, query, cluster, metrics: Sequence[str], deferred: bool = False):
        """Scoring closure with the per-(query, cluster) work hoisted out.

        The skeleton, its device copy and the ``QueryStatic`` come from the
        LRU (at most ONE skeleton build per pair), and every scored batch is
        one chunk: one placed forward per stack, its padded rows sliced off
        before the vote.  ``deferred`` makes the closure return a
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
        stacks = self._stacks_for(metrics)
        per_row = sum(len(level) for level in static.updates)  # the operators stage 3 updates

        def forward(chunk, i, stack, fw):
            a_place, n = chunk
            if fw.on:  # the exact plan: each level covers just its operators
                fw.set(rows3=int(a_place.shape[0]) * per_row, real3=n * per_row)
            raw = apply_gnn_placed_stacked(
                stack.params, skel, a_place, static, stack.cfgs[0].gnn, n_hw, self.policy.score_chunk
            )
            return raw, n

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
                launched = self._launch(stacks, n, None, lambda s, e: (a_place, n), forward)
                return self._finish("score", lambda: self._collect(stacks, launched), deferred)

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
        bucket-padded forward per stack and call; padding rows are sliced
        off, so results are independent of the bucket and of batchmates.
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        return self.scorer(query, cluster, metrics, deferred=deferred)(
            np.asarray(assignments, dtype=np.int64)
        )

    # -- cross-query broadcast batches -------------------------------------------

    def supports_cross_query(self, metrics: Optional[Sequence[str]] = None) -> bool:
        """Whether ``score_many`` answers ``metrics`` with merged forwards: no
        ``traditional_mp`` model among them (those aggregate over rounds, not
        stages, so they have no merged placed forward and ``score_many``
        answers them per request).  Metrics whose configs differ ride the
        merged forwards once per stack (``_stacks_for``).
        """
        metrics = tuple(metrics) if metrics is not None else tuple(self.models)
        return not any(self.models[m][1].traditional_mp for m in metrics)

    @classmethod
    def _host_graphs(cls, batch) -> JointGraph:
        """A batch as a numpy ``JointGraph`` with a batch axis (single graphs promoted)."""
        if not isinstance(batch, JointGraph):
            batch = cls._featurize(batch)
        g = JointGraph(*[np.asarray(x) for x in batch])
        return JointGraph(*[x[None] for x in g]) if g.op_x.ndim == 2 else g

    def _graph_chunks(self, merged: JointGraph, dev: Optional[JointGraph], banded: bool) -> Callable:
        """``estimate_many``'s chunk maker over a merged host batch: each chunk
        gets the signature-exact, row-trimmed banding of the structures it
        holds (``exact_banding_cached``; the fused plan, one ``mp_sweep``
        launch under ``use_pallas``), unless no stack is ``banded``.  Chunks
        are not padded: the forward runs eagerly, so a power-of-two row count
        would only add work.  ``dev``, the merged batch already on the device
        (``stage_graph_batches``), is sliced per chunk; without it each chunk
        is copied to the device on its own."""

        def prepare(s: int, e: int) -> _GraphChunk:
            chunk = JointGraph(*[x[s:e] for x in merged])
            banding = None
            if banded:
                with obs.span("host.banding") as sp:
                    banding, hit = exact_banding_lookup(chunk)
                    sp.set(hit=hit)
            g = graphs_to_device(chunk, self.device) if dev is None else JointGraph(*[x[s:e] for x in dev])
            return _GraphChunk(chunk, g, banding)

        return prepare

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
        layout: the batches concatenate along the batch axis and one forward
        per stack and ``max_rows`` chunk answers everything.  Returns one
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
            if n and self.device.type == "cpu":  # each chunk's tensors are views of these arrays
                merged, dev = merge_graph_batches(host).graphs, None
            mg.set(graphs=n)
        sp.set(n=n)
        if n == 0:
            raise ValueError("no graphs to estimate")
        self._before("estimate_many", n)
        if self.device.type != "cpu":  # one copy on the host, straight into the staging buffer
            merged, dev = stage_graph_batches(host, self.device)
        stacks = self._stacks_for(metrics)
        banded = not all(st.cfgs[0].traditional_mp for st in stacks)  # traditional_mp has no stage 3
        launched = self._launch(stacks, n, max_rows, self._graph_chunks(merged, dev, banded), _graph_forward)
        return self._finish("estimate_many", lambda: self._collect(stacks, launched, sizes), deferred)

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
        every (metric, member, candidate) triple (one forward per stack when
        the metrics' configs differ).  ``keys`` optionally
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
        stacks = self._stacks_for(metrics)
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
        launched = self._launch(
            stacks, n, max_rows, self._placed_chunks(group, stacks, skel_id, a_place), self._placed_forward
        )
        block_sizes = [len(b) for b in blocks]

        def finalize() -> List[Dict[str, np.ndarray]]:
            # split each structure's block back onto its requests, in order
            parts = self._collect(stacks, launched, block_sizes)
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

    def _placed_chunks(self, group: _MergedGroup, stacks, skel_id: np.ndarray, a_place: np.ndarray) -> Callable:
        """``score_many``'s chunk maker over a structure-major placement batch.

        On a GPU a chunk runs at its row bucket (``graphs.row_bucket``): its
        rows, padded, go to the static inputs of the group's graph for each
        stack and that bucket (``_graph_in``), in one copy each.  On the CPU the rows go to
        the device in one copy and each chunk is a slice of them."""
        if group.consts is None:
            skel_id_dev, a_place_dev = nn.arrays_to_device([skel_id, a_place], self.device)

        def prepare(s: int, e: int) -> _PlacedChunk:
            rows = skel_id[s:e]
            if group.consts is None:
                return _PlacedChunk(group, rows, (), skel_id_dev[s:e], a_place_dev[s:e])
            bucket = row_bucket(len(rows))
            graphs = tuple(self._graph_in(group.graphs, (id(st), bucket), lambda pool, st=st: merged_graph(
                st, group.consts, bucket, a_place.shape[1:], self.device, pool)) for st in stacks)
            for graph in graphs:
                graph.stage(padded_parts(rows, a_place[s:e], graph.rows))
            return _PlacedChunk(group, rows, graphs)

        return prepare

    def _placed_forward(self, chunk: _PlacedChunk, i: int, stack: StackedEnsembles, fw):
        """``score_many``'s forward of a chunk over ``stacks[i]``: on a GPU its
        graph replayed (captured on first sight; ``graphs.merged_graph``), on
        the CPU ``apply_gnn_merged`` unpadded; only the real rows are read back."""
        group = chunk.group
        if chunk.graphs:
            raw, how = chunk.graphs[i].run()
        else:
            how = "eager"
            raw = apply_gnn_merged(
                stack.params, group.skels, chunk.skel_id, chunk.a_place,
                stack.cfgs[0].gnn, group.banding, group.max_parents,
            )
        if fw.on:  # the banded plan over the skeletons' rows, pad rows included
            fw.set(rows3=int(raw.shape[-1]) * _level_rows(group.banding),
                   real3=int(group.real3[chunk.rows].sum()), graph=how)
        return raw, len(chunk.rows)

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
