"""Host-side data pipeline: trace corpus -> bucketed depth-major graph batches.

The port of ``repro/training/batching.py``.  Features are materialized once
(numpy); an epoch iterator then yields batches, as numpy arrays or, with
``device=``, as tensors on a device.  Padding policy is shared with the
placement scorer via ``core/bucketing.py``.

The training iterator is **bucketed by (n_ops, depth)** (``bucket_dataset``
/ ``bucketed_batches``): graphs of one bucket share a static
``BatchBanding`` stage-3 plan, so each step runs only the bucket's non-empty
depth levels at their banded row spans instead of MAX_DEPTH full-width
sweeps.  Every numpy ``rng`` call is the JAX package's, in the same order,
so both packages draw the same batches from the same seed.

A batch goes to a CUDA device as ONE copy: its eight graph fields and its
labels are packed into one page-locked host buffer, copied with
``non_blocking=True`` and viewed back as tensors on the device.  Under
``prefetch(..., device=)`` the worker thread only gathers and packs (host
work); the consuming thread makes the copy, on its own current stream, so
the copy is ordered before the step that reads it without any event.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from itertools import groupby
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bucketing import batch_banding_cached, exact_banding_cached
from repro_torch.core.graph import BatchBanding, JointGraph, batch_graphs, build_graph
from repro_torch.core.model import label_array
from repro_torch.dsps.generator import Trace


@dataclass
class GraphDataset:
    graphs: JointGraph  # batched numpy arrays, leading dim = N
    labels: np.ndarray  # (N,) for the selected metric

    def __len__(self) -> int:
        return int(self.graphs.op_x.shape[0])

    def select(self, idx: Union[np.ndarray, slice]) -> "GraphDataset":
        """Row subset.  A ``slice`` (or a contiguous, step-1 index vector) is
        applied as a numpy view — zero copies of the eight graph fields — the
        epoch-shuffling hot path re-slices buckets every epoch and fancy
        indexing re-materialized the whole ``JointGraph`` each time."""
        if not isinstance(idx, slice):
            idx = np.asarray(idx)
            # guards: a boolean mask can compare element-equal to an arange
            # (True == 1) but means something else, and a negative start
            # would turn into a slice crossing the end of the array
            if (
                idx.ndim == 1
                and idx.size
                and idx.dtype != np.bool_
                and int(idx[0]) >= 0
                and np.array_equal(idx, np.arange(int(idx[0]), int(idx[0]) + idx.size))
            ):
                idx = slice(int(idx[0]), int(idx[0]) + idx.size)
        g = JointGraph(*[getattr(self.graphs, f)[idx] for f in JointGraph._fields])
        return GraphDataset(graphs=g, labels=self.labels[idx])


def dataset_from_traces(traces: List[Trace], metric: str, transform=None) -> GraphDataset:
    singles = [build_graph(t.query, t.cluster, t.placement) for t in traces]
    if transform is not None:
        singles = [transform(g) for g in singles]
    return GraphDataset(graphs=batch_graphs(singles), labels=label_array(traces, metric))


def split_indices(
    n: int, fractions: Tuple[float, float, float] = (0.8, 0.1, 0.1), seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic train/val/test index split (paper: 80/10/10).

    The permutation is the argsort of the raw PCG64 bit stream
    (``np.random.PCG64(seed).random_raw``), the one stream numpy's
    compatibility policy (NEP 19) pins across releases, exactly as the JAX
    package splits: both packages put the same traces in each split.
    """
    perm = np.argsort(np.random.PCG64(seed).random_raw(n), kind="stable")
    n_tr = int(fractions[0] * n)
    n_va = int(fractions[1] * n)
    return perm[:n_tr], perm[n_tr : n_tr + n_va], perm[n_tr + n_va :]


def split_dataset(
    ds: GraphDataset, fractions: Tuple[float, float, float] = (0.8, 0.1, 0.1), seed: int = 0
) -> Tuple[GraphDataset, GraphDataset, GraphDataset]:
    """train/val/test split (paper: 80/10/10); see ``split_indices``."""
    tr, va, te = split_indices(len(ds), fractions, seed)
    return ds.select(tr), ds.select(va), ds.select(te)


# -- host -> device ----------------------------------------------------------------


class StagedBatch(NamedTuple):
    """One batch's graph fields and labels packed into one host buffer
    (page-locked when it is bound for a CUDA device)."""

    buf: torch.Tensor  # uint8
    layout: Tuple[Tuple[int, int, torch.dtype, Tuple[int, ...]], ...]  # (offset, bytes, dtype, shape), labels last

    @classmethod
    def of(cls, g: JointGraph, y: np.ndarray, pin: bool) -> "StagedBatch":
        arrays = [np.ascontiguousarray(x) for x in g] + [np.ascontiguousarray(y)]
        layout, off = [], 0
        for a in arrays:
            layout.append((off, a.nbytes, torch.from_numpy(a).dtype, a.shape))
            off += -(-a.nbytes // 8) * 8  # 8-byte aligned, so every field views back
        buf = torch.empty((max(off, 1),), dtype=torch.uint8, pin_memory=pin)
        host = buf.numpy()
        for (o, n, _, _), a in zip(layout, arrays):
            host[o : o + n] = a.reshape(-1).view(np.uint8)
        return cls(buf, tuple(layout))

    def to(self, device) -> Tuple[JointGraph, torch.Tensor]:
        """The batch on ``device`` after one copy (asynchronous from pinned memory)."""
        buf = self.buf.to(device, non_blocking=True)
        fields = [buf[o : o + n].view(dtype).view(shape) for o, n, dtype, shape in self.layout]
        return JointGraph(*fields[:-1]), fields[-1]


def batch_to_device(g: JointGraph, y: np.ndarray, device) -> Tuple[JointGraph, torch.Tensor]:
    """A host batch as tensors on ``device``: views of the numpy arrays on
    the CPU, one pinned staging buffer and one copy on a GPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return JointGraph(*[torch.from_numpy(np.ascontiguousarray(x)) for x in g]), torch.from_numpy(
            np.ascontiguousarray(y)
        )
    return StagedBatch.of(g, y, pin=True).to(device)


# -- plain epoch iteration ----------------------------------------------------------


def batches(
    ds: GraphDataset,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_remainder: bool = False,
) -> Iterator[Tuple[JointGraph, np.ndarray]]:
    """Plain (un-bucketed) epoch iterator; kept for eval and simple callers."""
    n = len(ds)
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if drop_remainder and idx.size < batch_size:
            return
        if idx.size < batch_size:
            # pad by repeating (training tolerates duplicate samples in the tail)
            idx = np.concatenate([idx, order[: batch_size - idx.size]])
        sub = ds.select(idx)
        yield sub.graphs, sub.labels


# -- (n_ops, depth)-bucketed iteration (the training fast path) -----------------


@dataclass(frozen=True)
class BucketSpec:
    """One bucket: a contiguous row range of the resorted dataset plus its
    static stage-3 banding (shared by every batch drawn from the bucket).
    Conservative buckets group by (n_ops, depth); exact buckets group by the
    full per-row (type, depth) signature."""

    n_ops: int
    depth: int
    start: int
    stop: int
    banding: BatchBanding

    def __len__(self) -> int:
        return self.stop - self.start


def bucket_dataset(ds: GraphDataset, exact: bool = False) -> Tuple[GraphDataset, Tuple[BucketSpec, ...]]:
    """Sort the dataset into banding buckets and describe them.

    Returns the resorted dataset (one fancy-index pass — per-epoch work then
    selects contiguous views) and one ``BucketSpec`` per bucket.

    ``exact=False`` (default): stable-sort by (depth, n_ops), one bucket per
    distinct (n_ops, depth) key; same-depth buckets share one conservative
    banding computed over the whole contiguous depth class, which covers
    every sub-batch of the class, padding included.

    ``exact=True``: one bucket per distinct per-row (type, depth)
    *signature* (``bucketing.batch_signature``), each carrying its
    signature-exact row-trimmed banding — stage work proportional to real
    rows.  The right trade for large fixed corpora (``launch/train.py``).

    Either way the bandings come from the signature-keyed cache.
    """
    if not len(ds):
        return ds, ()
    mask = np.asarray(ds.graphs.op_mask) > 0
    n_ops = mask.sum(axis=-1).astype(np.int64)
    depth = (np.asarray(ds.graphs.op_depth) * mask).max(axis=-1).astype(np.int64)
    if exact:
        sig = np.where(mask, np.asarray(ds.graphs.op_depth), -1).astype(np.int64)
        _, inverse = np.unique(sig, axis=0, return_inverse=True)
        # secondary keys keep signature classes inside depth-major order
        order = np.lexsort((inverse, n_ops, depth))
        class_of = inverse[order]
    else:
        # depth-primary so buckets sharing a banding (= a depth class) stay
        # contiguous: bucketed_batches draws batches per banding group
        order = np.lexsort((n_ops, depth))
        class_of = None
    ds = ds.select(order)
    n_ops, depth = n_ops[order], depth[order]
    if exact:
        bounds = np.flatnonzero(np.diff(class_of) != 0)
    else:
        bounds = np.flatnonzero((np.diff(n_ops) != 0) | (np.diff(depth) != 0))
        shared = {}
        for d in np.unique(depth):
            rows = np.flatnonzero(depth == d)  # contiguous after the sort
            shared[int(d)] = _class_banding(ds, int(rows[0]), int(rows[-1]) + 1, exact=False)
    starts = np.concatenate([[0], bounds + 1])
    stops = np.concatenate([bounds + 1, [len(ds)]])
    buckets = tuple(
        BucketSpec(
            n_ops=int(n_ops[a]),
            depth=int(depth[a]),
            start=int(a),
            stop=int(b),
            banding=(_class_banding(ds, int(a), int(b), exact=True) if exact else shared[int(depth[a])]),
        )
        for a, b in zip(starts, stops)
    )
    return ds, buckets


def _class_banding(ds: GraphDataset, start: int, stop: int, exact: bool) -> BatchBanding:
    """Banding for one contiguous class, via the signature-keyed cache."""
    g = ds.select(slice(start, stop)).graphs
    return exact_banding_cached(g) if exact else batch_banding_cached(g)


def _banding_groups(buckets: Sequence[BucketSpec]):
    """Consecutive buckets sharing a banding (one group per depth class)."""
    return [(banding, list(group)) for banding, group in groupby(buckets, key=lambda b: b.banding)]


def bucketed_batches(
    ds: GraphDataset,
    buckets: Sequence[BucketSpec],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> Iterator[Tuple[JointGraph, object, BatchBanding]]:
    """Depth-major epoch iterator over a ``bucket_dataset`` result.

    Yields ``(graphs, labels, banding)`` with every batch drawn from a single
    *banding group* (the contiguous buckets of one depth class, which share
    the static plan and the padded batch shape).  Only each group's single
    epoch tail is padded to ``batch_size``, by wrapping the group's own
    (shuffled) order: at most ``batch_size - 1`` duplicate samples per group
    per epoch.  ``rng`` shuffles within buckets and interleaves the batch
    order across groups.  ``device`` (None: numpy on the host) moves each
    batch there in this thread (``batch_to_device``); to overlap the host
    work with the device, leave it None and pass ``device`` to ``prefetch``.
    """
    plan = []
    for banding, group in _banding_groups(buckets):
        parts = []
        for b in group:
            part = np.arange(b.start, b.stop)
            parts.append(rng.permutation(part) if rng is not None else part)
        idx = np.concatenate(parts)
        for s in range(0, len(idx), batch_size):
            take = idx[s : s + batch_size]
            if take.size < batch_size:  # wrap the group's order, like the plain iterator
                take = np.concatenate([take, np.resize(idx, batch_size - take.size)])
            plan.append((take, banding))
    if rng is not None:
        plan = [plan[i] for i in rng.permutation(len(plan))]
    for take, banding in plan:
        sub = ds.select(take)
        g, y = sub.graphs, sub.labels
        if device is not None:
            g, y = batch_to_device(g, y, device)
        yield g, y, banding


def n_batches(buckets: Sequence[BucketSpec], batch_size: int) -> int:
    """Steps per epoch of ``bucketed_batches`` (for LR schedules)."""
    return sum(-(-sum(len(b) for b in group) // batch_size) for _, group in _banding_groups(buckets))


def prefetch(it: Iterator, size: int = 2, device=None) -> Iterator:
    """Background-thread prefetch (overlaps host prep with device compute).

    With ``device``, ``it`` yields host batches ``(graphs, labels, *rest)``;
    the worker packs each into a ``StagedBatch`` (page-locked for a GPU) and
    this thread moves it to ``device`` with one copy as it yields it.  An
    exception in the worker is raised here.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = object()
    failed = []
    pin = device is not None and torch.device(device).type == "cuda"

    def worker():
        try:
            for item in it:
                if device is not None:
                    g, y, *rest = item
                    item = (StagedBatch.of(g, y, pin=pin), *rest)
                q.put(item)
        except BaseException as e:  # re-raised by the consumer below
            failed.append(e)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            t.join()
            if failed:
                raise failed[0]
            return
        if device is not None:
            staged, *rest = item
            item = (*staged.to(device), *rest)
        yield item
