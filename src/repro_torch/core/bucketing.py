"""Shared padding / shape-bucket / stage-3 banding policy for jitted batches.

Training and placement scoring both feed ragged work (trace corpora,
candidate sets, merged request streams) through jitted forwards, and jitted
forwards retrace per input shape.  This module is the single place that
decides how a ragged count becomes a static shape, and how a batch's depth
structure becomes a static stage-3 plan:

* ``bucket_size``     — the enclosing power-of-two candidate-count bucket the
                        placement scorer pads to;
* ``pad_batch``       — pad a batched ``JointGraph``-like NamedTuple along
                        axis 0 by repeating the last row, so every padded row
                        stays a well-formed graph (masks and slot types
                        intact) and bucketed jit shapes never see garbage;
* ``batch_banding``   — bucket-conservative per-depth ``row_span`` /
                        ``parent_rows`` bounds (valid for every sub-batch of
                        a bucket; the shared-plan training default);
* ``exact_banding``   — per-row (type, depth) **signature-exact** bands with
                        static row trimming: spans computed from exactly the
                        signatures present in the batch, and rows that carry
                        no operator in ANY member dropped from the layout
                        entirely.  Cached on an exact key of the signature set
                        (``exact_banding_cached``) so zero-copy views and
                        merged request batches never recompute or retrace.

The training iterator (``training/batching.bucketed_batches``) applies the
same duplicate-samples-never-foreign-shapes policy at the index level: epoch
tails are padded by wrapping the banding group's own shuffled order.
Callers always slice predictions back to the true count; padded rows are
scored/trained but meaningless (placement) or benign duplicates (training).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import obs


def bucket_size(n: int) -> int:
    """Smallest power of two >= n: the jit shape buckets the scorer pads to."""
    assert n > 0, n
    return 1 << (n - 1).bit_length()


def pad_batch(g, target: int):
    """Pad a batched graph NamedTuple along axis 0 to ``target`` rows.

    Padding repeats the last graph, so every row stays a well-formed graph
    (masks and slot types intact) and bucketed jit shapes never see garbage;
    callers slice predictions back to the true count.  Works on any NamedTuple
    of batched arrays (``JointGraph`` in practice).
    """
    fields = [np.asarray(x) for x in g]
    n = fields[0].shape[0]
    assert all(x.shape[0] == n for x in fields), "fields disagree on batch size"
    assert n <= target, (n, target)
    if n == target:
        return g
    return type(g)(
        *[
            np.pad(x, [(0, target - n)] + [(0, 0)] * (x.ndim - 1), mode="edge")
            for x in fields
        ]
    )


# -- stage-3 banding --------------------------------------------------------------


class BatchBanding(NamedTuple):
    """Static stage-3 plan for a batch of graphs in the depth-major layout.

    ``levels`` holds, for every depth ``d >= 1`` at which ANY graph of the
    batch has an operator, the tuple ``(d, (start, stop), parent_rows)``:

    * ``(start, stop)`` — row span covering every batch graph's depth-``d``
      rows.  Rows outside the span are provably never selected at depth ``d``
      for any graph in the batch, so the message-passing step can statically
      skip their dense work (``kernels/mp_update``'s ``row_span``);
    * ``parent_rows`` — exclusive upper bound on the rows that feed messages
      into the span: ``a_flow[u, v] == 0`` for every ``u >= parent_rows`` and
      every selected ``v``, across the whole batch (the kernel's contraction
      bound).

    ``rows``/``ranges`` are the optional **row trim** (``exact_banding``):
    when set, the forward statically gathers just ``rows`` (ascending padded
    row indices — every row that holds a real operator in at least one batch
    member) and runs every stage on that trimmed layout, whose type runs are
    ``ranges``; ``levels`` then live in trimmed coordinates.  ``rows=None``
    (the conservative ``batch_banding`` output) means the full padded layout
    with the canonical ``graph.SLOT_RANGES``.

    Being a tuple-of-ints NamedTuple it is hashable and serves as the static
    jit-cache key for bucketed training steps and merged serving forwards:
    one trace per banding, and the scan runs ``len(levels)`` banded steps
    instead of MAX_DEPTH full-width ones.
    """

    levels: Tuple[Tuple[int, Tuple[int, int], int], ...]
    rows: Optional[Tuple[int, ...]] = None
    ranges: Optional[Tuple[Tuple[int, int, int], ...]] = None


def _batch_arrays(g):
    """(depth, mask, flow, types) as 2-D/3-D numpy, single graphs promoted."""
    depth = np.asarray(g.op_depth)
    mask = np.asarray(g.op_mask) > 0
    flow = np.asarray(g.a_flow)
    types = np.asarray(g.op_type)
    if depth.ndim == 1:  # single graph: treat as a one-element bucket
        depth, mask, flow, types = depth[None], mask[None], flow[None], types[None]
    return depth, mask, flow, types


def batch_banding(g) -> BatchBanding:
    """Host-side (numpy) conservative banding for a batched graph.

    Computed once per (n_ops, depth) bucket at dataset-bucketing time, NOT per
    batch: all batches of one bucket must share the static plan or the jitted
    step would retrace per batch.  The banding is *conservative*: valid for
    every sub-batch drawn from the bucket (padding included, since padded rows
    repeat bucket graphs).

    Like ``exact_banding``, the plan is a pure function of
    ``batch_signature(g)``: ``parent_rows`` bounds the contraction by the
    last row that is active at any depth ``< d`` — every edge into a
    depth-``d`` row comes from a strictly shallower active row, so the bound
    covers every possible ``a_flow`` over these signatures (what makes the
    signature-keyed banding caches sound).
    """
    depth, mask, _, _ = _batch_arrays(g)
    active = depth * mask
    levels = []
    for d in range(1, int(active.max(initial=0)) + 1):
        sel = (depth == d) & mask  # (B, N)
        if not sel.any():
            continue
        rows = np.flatnonzero(sel.any(axis=0))
        span = (int(rows[0]), int(rows[-1]) + 1)
        shallower = np.flatnonzero(((depth < d) & mask).any(axis=0))
        parent_rows = int(shallower[-1]) + 1 if shallower.size else 1
        levels.append((d, span, parent_rows))
    return BatchBanding(levels=tuple(levels))


def _type_runs(types) -> Tuple[Tuple[int, int, int], ...]:
    """Maximal runs of equal node type over ``types`` as (type, start, stop)."""
    runs = []
    for i, t in enumerate(int(x) for x in types):
        if runs and runs[-1][0] == t:
            runs[-1][2] = i + 1
        else:
            runs.append([t, i, i + 1])
    return tuple(tuple(r) for r in runs)


def batch_signature(g) -> Tuple[Tuple[int, ...], ...]:
    """Sorted unique per-graph row signatures of a batch — the banding key.

    A graph's row signature is the per-row topological depth with padded rows
    encoded as ``-1``; exact banding is a pure function of the *set* of
    signatures present (padding repeats members, so it never changes the
    key), which is what makes ``exact_banding_cached`` sound for every view,
    sub-batch, and merged request stream drawn from the same structures.
    """
    depth, mask, _, _ = _batch_arrays(g)
    sig = np.where(mask, depth, -1).astype(np.int64)
    return tuple(sorted(set(map(tuple, sig.tolist()))))


def exact_banding(g) -> BatchBanding:
    """Signature-exact bands + depth-clustered row trimming for a batch.

    Where ``batch_banding`` shares one conservative plan across a whole
    bucket, this plan is exact for the batch's per-row (type, depth)
    signatures: rows holding no operator in ANY member are statically dropped
    from the layout, and the kept rows are **reordered by mean active depth**
    (type, then slot, as tie-breaks).  Rows the stage-3 sweep selects at the
    same depth thereby cluster, so each level's span hull — and with it the
    level's aggregation + banked-MLP row work — shrinks toward the rows
    actually selected, instead of spanning whatever the canonical layout
    interleaves between them.  Correctness never depends on the order
    (selection inside a span stays dynamic); only the spans' tightness does.

    The plan is built from ``batch_signature(g)`` alone — ``parent_rows`` is
    the last kept row active at any depth ``< d`` (every data-flow edge comes
    from a strictly shallower row), not a function of ``a_flow`` — which
    makes it a pure function of the signature set: cacheable, multiplicity-
    independent, and valid for any padding that repeats members.  Costs one
    jit trace per distinct signature set; buys stage work proportional to
    real rows instead of the widest member.
    """
    sig = np.asarray(batch_signature(g), dtype=np.int64)  # (U, N), -1 = padded
    types = np.asarray(g.op_type)
    if types.ndim == 2:
        types = types[0]  # padded slots carry their range's type: rows agree
    keep = np.flatnonzero((sig >= 0).any(axis=0))
    if keep.size == 0:
        return BatchBanding(levels=())
    mean_depth = {
        int(r): float(np.mean(sig[:, r][sig[:, r] >= 0])) for r in keep
    }
    order = sorted(
        (int(r) for r in keep), key=lambda r: (mean_depth[r], int(types[r]), r)
    )
    sig_k = sig[:, order]  # (U, n) in the trimmed, depth-clustered layout
    levels = []
    for d in range(1, int(sig_k.max(initial=0)) + 1):
        rows = np.flatnonzero((sig_k == d).any(axis=0))
        if not rows.size:
            continue
        span = (int(rows[0]), int(rows[-1]) + 1)
        shallower = np.flatnonzero(((sig_k >= 0) & (sig_k < d)).any(axis=0))
        parent_rows = int(shallower[-1]) + 1 if shallower.size else 1
        levels.append((d, span, parent_rows))
    if keep.size == sig.shape[1] and order == list(range(sig.shape[1])):
        return BatchBanding(levels=tuple(levels))  # full width, canonical order
    return BatchBanding(
        levels=tuple(levels),
        rows=tuple(order),
        ranges=_type_runs(types[np.asarray(order)]),
    )


# (flavor, ``banding_key``) -> BatchBanding.  Bands are pure functions of the
# signature set, so one cache serves every consumer (dataset buckets,
# zero-copy views, merged serving chunks) and bounds both recomputation and
# jit retraces.  Capacity comes from the active DispatchPolicy
# (``banding_cache_size``; sizing rationale in serve/policy.py).
_BANDING_CACHE: dict = {}


def _banding_cache_capacity() -> int:
    from repro_torch.serve.policy import active_policy  # lazy: core never pulls serve at import

    return active_policy().banding_cache_size


# A row signature packs into one int64 when each slot's ``depth + 1`` (0 for a
# padded slot) fits its 4 bits and the slots fit 60 bits.
_SLOT_BITS = 4
_PACKED_SLOTS = 15


def banding_key(g):
    """An exact key of ``batch_signature(g)``'s set, without building row tuples.

    Each row packs ``depth + 1`` (0 for a padded slot) into 4 bits per slot,
    one int64 a row; the key is the row width and the sorted unique codes as
    bytes.  Packing is injective on the signatures (a real slot at depth -1
    reads as padded in both), so two batches share a key exactly when their
    signature sets are equal.  Rows wider than 15 slots, a depth outside -1 to
    14, or depths that are not signed integers key on the signature tuples
    instead, which never equal a packed key.
    """
    depth, mask, _, _ = _batch_arrays(g)
    n_slots = depth.shape[1]
    code = (depth + 1) * mask  # a signed overflow reads negative
    if (depth.dtype.kind != "i" or n_slots > _PACKED_SLOTS
            or code.size and not (code.min() >= 0 and code.max() < 1 << _SLOT_BITS)):
        return batch_signature(g)
    weights = np.left_shift(1, np.arange(0, _SLOT_BITS * n_slots, _SLOT_BITS, dtype=np.int64))
    return n_slots, np.unique(code @ weights).tobytes()


def _banding_lookup(g, flavor: str, compute) -> Tuple[BatchBanding, bool]:
    """(banding, whether the cache held it); counts ``cache.banding.{hit,miss}``."""
    key = (flavor, banding_key(g))
    hit = _BANDING_CACHE.get(key)
    if hit is not None:
        obs.count("cache.banding.hit")
        return hit, True
    obs.count("cache.banding.miss")
    if len(_BANDING_CACHE) >= _banding_cache_capacity():
        _BANDING_CACHE.clear()  # tiny entries; full reset beats LRU churn
    banding = _BANDING_CACHE[key] = compute(g)
    return banding, False


def exact_banding_lookup(g) -> Tuple[BatchBanding, bool]:
    """``exact_banding`` memoized on ``batch_signature(g)``'s set, and whether it was a hit."""
    return _banding_lookup(g, "exact", exact_banding)


def exact_banding_cached(g) -> BatchBanding:
    """``exact_banding`` memoized on ``batch_signature(g)``."""
    return exact_banding_lookup(g)[0]


def batch_banding_cached(g) -> BatchBanding:
    """``batch_banding`` memoized on ``batch_signature(g)``."""
    return _banding_lookup(g, "conservative", batch_banding)[0]
