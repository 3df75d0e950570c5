"""Joint operator-resource graph (paper SIII-A) as padded dense arrays.

COSTREAM graphs are tiny (<= ~12 operators, <= 8 hosts) but ragged; on TPU we
represent them as fixed-shape padded blocks so batched message passing becomes
masked matmuls (see DESIGN.md SS4). One ``JointGraph`` holds a *batch* of
graphs when arrays carry a leading batch dim; ``batch_graphs`` stacks singles.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np

from repro_torch.core import features as F
from repro_torch.dsps.hardware import Cluster
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import Query

MAX_OPS = 12
MAX_HW = 8
# Longest source->sink chain in the corpus: source + 4 filters + agg + sink
# (depth 6) and the Exp-5 filter-chain variants; 8 leaves head-room while
# keeping the stage-3 scan short (it dominates step time).
MAX_DEPTH = 8

# Canonical DEPTH-MAJOR slot layout: operator i of type t occupies a slot
# inside t's static range, and the ranges themselves are ordered by where the
# type sits in the data flow (sources -> filters -> joins -> aggregations ->
# sink).  Two properties follow:
#   * type-specific MLPs run on static slices instead of masked full-width
#     banks (see nn.apply_mlp_bank_slotted) — a 5x FLOP cut that is also the
#     layout the Pallas kernel tiles on;
#   * topological depth is (for every corpus query shape: linear chains,
#     2-way and 3-way joins) non-decreasing along the slot axis, so each
#     stage-3 depth level occupies a narrow row band and ``batch_banding``
#     can hand the message-passing kernel tight static ``row_span`` /
#     ``parent_rows`` bounds.  Correctness never depends on the monotonicity
#     (banding is computed from the actual depths and only ever widens), only
#     the bands' tightness does.
#   type id: SOURCE=0, FILTER=1, AGGREGATE=2, JOIN=3, SINK=4 (features.OP_TYPE_IDS)
SLOT_RANGES = (
    (0, 0, 3),  # up to 3 sources (depth 0)
    (1, 3, 7),  # up to 4 filters (source chains, shallow)
    (3, 7, 9),  # up to 2 joins (after the filtered chains)
    (2, 9, 11),  # up to 2 aggregations (after joins in the corpus shapes)
    (4, 11, 12),  # 1 sink (always the deepest node)
)


class JointGraph(NamedTuple):
    """Padded joint graph; all fields are numpy/jnp arrays.

    Shapes below are for a single graph; batched graphs prepend a batch dim.
    """

    op_x: np.ndarray  # (MAX_OPS, OP_FEATURE_DIM) float32
    op_type: np.ndarray  # (MAX_OPS,) int32  in [0, N_OP_TYPES); padded rows are 0
    op_mask: np.ndarray  # (MAX_OPS,) float32 {0,1}
    op_depth: np.ndarray  # (MAX_OPS,) int32 topological depth; padded rows 0
    hw_x: np.ndarray  # (MAX_HW, HW_FEATURE_DIM) float32
    hw_mask: np.ndarray  # (MAX_HW,) float32 {0,1}
    a_flow: np.ndarray  # (MAX_OPS, MAX_OPS) float32; a_flow[u, v] = 1 iff u -> v
    a_place: np.ndarray  # (MAX_OPS, MAX_HW) float32; a_place[i, j] = 1 iff op i on host j

    @property
    def batched(self) -> bool:
        return self.op_x.ndim == 3


def _slot_assignment(query: Query) -> dict:
    """op_id -> canonical slot (inside its type's static range)."""
    base = {t: (start, stop) for (t, start, stop) in SLOT_RANGES}
    counts = {t: 0 for (t, _, _) in SLOT_RANGES}
    slots = {}
    for op in query.operators:
        t = F.op_type_id(op)
        start, stop = base[t]
        assert counts[t] < stop - start, (
            f"query exceeds slot capacity for type {t}: {query.describe()}"
        )
        slots[op.op_id] = start + counts[t]
        counts[t] += 1
    return slots


def build_graph_skeleton(
    query: Query,
    cluster: Cluster,
    max_ops: int = MAX_OPS,
    max_hw: int = MAX_HW,
) -> JointGraph:
    """The placement-invariant part of a joint graph (``a_place`` all zero).

    Query and cluster features do not depend on where operators run, so a
    skeleton can be materialized once and shared across every candidate
    placement of the same (query, cluster) pair — the single-materialization
    contract ``build_graph_batch`` relies on.
    """
    n_ops, n_hw = query.n_ops(), cluster.n_nodes()
    assert n_ops <= max_ops, f"query has {n_ops} ops > pad {max_ops}"
    assert n_hw <= max_hw, f"cluster has {n_hw} hosts > pad {max_hw}"

    op_x = np.zeros((max_ops, F.OP_FEATURE_DIM), dtype=np.float32)
    op_type = np.zeros((max_ops,), dtype=np.int32)
    op_mask = np.zeros((max_ops,), dtype=np.float32)
    op_depth = np.zeros((max_ops,), dtype=np.int32)
    hw_x = np.zeros((max_hw, F.HW_FEATURE_DIM), dtype=np.float32)
    hw_mask = np.zeros((max_hw,), dtype=np.float32)
    a_flow = np.zeros((max_ops, max_ops), dtype=np.float32)
    a_place = np.zeros((max_ops, max_hw), dtype=np.float32)

    # fill padded slots with their range's type id so slotted MLPs stay exact
    for t, start, stop in SLOT_RANGES:
        op_type[start:stop] = t

    slot = _slot_assignment(query)
    depths = query.depths()
    for op in query.operators:
        i = slot[op.op_id]
        op_x[i] = F.featurize_operator(op)
        op_type[i] = F.op_type_id(op)
        op_mask[i] = 1.0
        op_depth[i] = depths[op.op_id]
    for node in cluster.nodes:
        hw_x[node.node_id] = F.featurize_hardware(node)
        hw_mask[node.node_id] = 1.0
    for u, v in query.edges:
        a_flow[slot[u], slot[v]] = 1.0

    return JointGraph(
        op_x=op_x,
        op_type=op_type,
        op_mask=op_mask,
        op_depth=op_depth,
        hw_x=hw_x,
        hw_mask=hw_mask,
        a_flow=a_flow,
        a_place=a_place,
    )


def skeleton_cache_key(query: Query, cluster: Cluster) -> Tuple:
    """Hashable structural fingerprint of the skeleton-determining inputs.

    Two (query, cluster) pairs with equal keys featurize to identical
    ``build_graph_skeleton`` outputs and ``query_static`` summaries: the key
    covers every operator field (``dataclasses.astuple`` recurses into
    ``WindowSpec``), the logical edges, and the hardware nodes — but not
    ``query.name``, which never reaches the featurizer.  Computing it is
    O(n_ops + n_hw) tuple building, far cheaper than the skeleton
    featurization + device transfer it lets callers amortize (the
    online-monitoring pattern re-scores the same query every round).
    """
    return (
        tuple(dataclasses.astuple(op) for op in query.operators),
        tuple(query.edges),
        tuple(cluster.nodes),
    )


def slot_index(query: Query) -> np.ndarray:
    """``slot_index(q)[op_id]`` = the canonical padded row of that operator."""
    slot = _slot_assignment(query)
    return np.asarray([slot[i] for i in range(query.n_ops())], dtype=np.int64)


class QueryStatic(NamedTuple):
    """Hashable trace-time summary of one query's structure in slot space.

    Drives the placement-specialized GNN forward (``gnn.apply_gnn_placed``):
    the stage-3 data-flow sweep is unrolled over ``updates`` — per depth level
    ``d >= 1``, the tuple of ``(slot, type_id, parent_slots)`` to update — so
    only the handful of slots that actually carry an operator at each depth
    are recomputed, instead of all ``MAX_OPS`` slots for all ``MAX_DEPTH``
    levels.  Being a tuple-of-ints NamedTuple it is hashable and serves as a
    jit-cache key alongside the model config.
    """

    active: Tuple[int, ...]  # slots holding a real operator, ascending
    updates: Tuple[Tuple[Tuple[int, int, Tuple[int, ...]], ...], ...]


def query_static(query: Query) -> QueryStatic:
    slot = _slot_assignment(query)
    depths = query.depths()
    levels = []
    for d in range(1, query.max_depth() + 1):
        level = []
        for op in query.operators:
            if depths[op.op_id] != d:
                continue
            parents = tuple(sorted(slot[p] for p in query.parents(op.op_id)))
            level.append((slot[op.op_id], F.op_type_id(op), parents))
        levels.append(tuple(sorted(level)))
    return QueryStatic(
        active=tuple(sorted(slot[i] for i in range(query.n_ops()))),
        updates=tuple(levels),
    )


def build_a_place_batch(
    query: Query,
    cluster: Cluster,
    assignments: np.ndarray,
    max_ops: int = MAX_OPS,
    max_hw: int = MAX_HW,
) -> np.ndarray:
    """Just the ``(N, max_ops, max_hw)`` placement adjacency of a batch."""
    assignments = np.asarray(assignments, dtype=np.int64)
    assert assignments.ndim == 2 and assignments.shape[1] == query.n_ops(), assignments.shape
    assert cluster.n_nodes() <= max_hw, f"cluster has {cluster.n_nodes()} hosts > pad {max_hw}"
    n = assignments.shape[0]
    a_place = np.zeros((n, max_ops, max_hw), dtype=np.float32)
    rows = slot_index(query)
    a_place[np.arange(n)[:, None], rows[None, :], assignments] = 1.0
    return a_place


def build_graph(
    query: Query,
    cluster: Cluster,
    placement: Placement,
    max_ops: int = MAX_OPS,
    max_hw: int = MAX_HW,
) -> JointGraph:
    g = build_graph_skeleton(query, cluster, max_ops, max_hw)
    a_place = np.zeros((max_ops, max_hw), dtype=np.float32)
    slot = _slot_assignment(query)
    for i in range(query.n_ops()):
        a_place[slot[i], placement.node_of(i)] = 1.0
    return g._replace(a_place=a_place)


def broadcast_skeleton(skel: JointGraph, a_place: np.ndarray) -> JointGraph:
    """Broadcast one skeleton against an ``(N, max_ops, max_hw)`` placement batch.

    Every placement-invariant field becomes a zero-copy broadcast view along
    the new batch axis (read-only — copy before mutating); only ``a_place``
    carries per-candidate data.  This is the single-materialization contract
    behind ``build_graph_batch`` and the cross-query merge path, which reuses
    LRU-cached skeletons instead of re-featurizing.
    """
    a_place = np.asarray(a_place)
    n = a_place.shape[0]
    return JointGraph(
        *[np.broadcast_to(np.asarray(x), (n,) + np.asarray(x).shape) for x in skel[:-1]],
        a_place=a_place,
    )


def build_graph_batch(
    query: Query,
    cluster: Cluster,
    assignments: np.ndarray,
    max_ops: int = MAX_OPS,
    max_hw: int = MAX_HW,
) -> JointGraph:
    """Batch of ``N`` candidate placements of one query, built in one pass.

    ``assignments`` is an ``(N, n_ops)`` int matrix (``assignments[c, op_id]``
    = host of ``op_id`` in candidate ``c``).  The skeleton is materialized
    once and broadcast (``broadcast_skeleton``); only ``a_place`` is written
    per candidate.  Equivalent to
    ``batch_graphs([build_graph(q, c, Placement.of(row)) for row in a])`` but
    O(1) featurization passes instead of O(N).
    """
    assignments = np.asarray(assignments, dtype=np.int64)
    assert assignments.ndim == 2 and assignments.shape[1] == query.n_ops(), assignments.shape
    g = build_graph_skeleton(query, cluster, max_ops, max_hw)
    return broadcast_skeleton(g, build_a_place_batch(query, cluster, assignments, max_ops, max_hw))


def batch_graphs(graphs: List[JointGraph]) -> JointGraph:
    return JointGraph(*[np.stack([getattr(g, f) for g in graphs]) for f in JointGraph._fields])


class BroadcastBatch(NamedTuple):
    """Several per-query graph batches merged along the shared batch axis.

    ``graphs`` is one ordinary batched ``JointGraph`` — every member shares
    the canonical depth-major padded layout, so batches from *different*
    query structures concatenate directly — and ``sizes`` remembers each
    source batch's row count so fused answers can be split back per request.
    """

    graphs: JointGraph
    sizes: Tuple[int, ...]


def merge_graph_batches(batches: List[JointGraph]) -> BroadcastBatch:
    """Concatenate per-query batches (broadcast views included) into ONE batch.

    The cross-query serving primitive: N distinct requests' graphs become one
    shared padded batch whose single stacked forward replaces N per-structure
    forwards (``CostEstimator.estimate_many`` / ``score_many``).  Broadcast
    views from ``broadcast_skeleton`` are materialized here, once, at merge
    time.
    """
    assert batches, "no batches to merge"
    sizes = tuple(int(np.asarray(b.op_x).shape[0]) for b in batches)
    merged = JointGraph(
        *[
            np.concatenate([np.asarray(getattr(b, f)) for b in batches], axis=0)
            for f in JointGraph._fields
        ]
    )
    return BroadcastBatch(graphs=merged, sizes=sizes)


# Padding / shape-bucket / stage-3 banding policy shared with the training
# pipeline lives in core/bucketing.py; re-exported here because the graph
# layout and its padding + banding contracts are one interface.
from repro_torch.core.bucketing import (  # noqa: E402,F401
    BatchBanding,
    batch_banding,
    batch_signature,
    bucket_size,
    exact_banding,
    exact_banding_cached,
    exact_banding_lookup,
    pad_batch,
)


# -- ablation transforms (Exp 7a) ----------------------------------------------


def drop_hardware(g: JointGraph) -> JointGraph:
    """Featurization ablation 1: operators only (no placement, no hardware)."""
    return g._replace(
        hw_mask=np.zeros_like(g.hw_mask),
        a_place=np.zeros_like(g.a_place),
        hw_x=np.zeros_like(g.hw_x),
    )


def drop_hw_features(g: JointGraph) -> JointGraph:
    """Featurization ablation 2: placement/co-location kept, hw features zeroed."""
    return g._replace(hw_x=np.zeros_like(g.hw_x))
