"""Placement candidate enumeration (paper SV, Fig. 5; after Governor [32]).

Candidates respect three IoT-scenario rules:
  (1) operator co-location is allowed,
  (2) data flows from same-or-weaker to stronger hardware bins,
  (3) placements are acyclic (data never returns to a previously left host).

The sampler is fully vectorized: it draws an ``(N, n_ops)`` assignment matrix
in one topological sweep (NumPy ops across the whole candidate axis) and
validates all rows with batched checks.  All consumers — the optimizer, the
flat-vector ranker, the Exp-2 benchmarks — operate on the raw matrix via
``sample_assignment_matrix``; convert a row with ``Placement.of(row)`` only
at the simulator/reporting boundary.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.dsps.hardware import Cluster, hardware_bin
from repro_torch.dsps.placement import (
    Placement,
    is_acyclic_placement,
    respects_increasing_capability,
)
from repro_torch.dsps.query import OpType, Query


def valid_candidate(query: Query, cluster: Cluster, placement: Placement) -> bool:
    return respects_increasing_capability(query, cluster, placement) and is_acyclic_placement(
        query, placement
    )


def heuristic_placement(query: Query, cluster: Cluster) -> Placement:
    """The deterministic initial placement baseline (after [32]).

    Sources go to the weakest bin (edge), each subsequent depth level moves to
    the next-stronger available node, round-robin within a level. This is the
    placement the paper compares its optimized placements against (Exp 2a) and
    the starting point of the monitoring baseline (Exp 2b).
    """
    by_strength = sorted(
        cluster.nodes, key=lambda n: (hardware_bin(n), n.cpu, n.ram_mb, n.bandwidth_mbps)
    )
    depths = query.depths()
    max_d = max(depths.values())
    assign = [0] * query.n_ops()
    n = len(by_strength)
    rr = {}
    for op in query.operators:
        d = depths[op.op_id]
        # map depth range onto node-strength range
        idx = int(round(d / max(max_d, 1) * (n - 1)))
        # round-robin among equal-depth operators across neighboring nodes
        bump = rr.get(d, 0)
        rr[d] = bump + 1
        idx = min(n - 1, idx + (bump % 2))
        assign[op.op_id] = by_strength[idx].node_id
    p = Placement.of(assign)
    if not valid_candidate(query, cluster, p):
        # fall back: everything on the strongest node is always valid
        p = Placement.of([by_strength[-1].node_id] * query.n_ops())
    return p


# -- vectorized sampling --------------------------------------------------------


def batch_validity_mask(
    query: Query,
    cluster: Cluster,
    assignments: np.ndarray,
    paths: Optional[List[List[int]]] = None,
) -> np.ndarray:
    """Vectorized Fig.-5 rule check over an ``(N, n_ops)`` assignment matrix.

    Row i is True iff ``Placement.of(assignments[i])`` passes
    ``valid_candidate`` — the batched twin of the scalar predicates in
    ``repro_torch.dsps.placement`` (kept: they are the readable spec).  ``paths``
    (placement-invariant) can be precomputed via ``query.root_to_sink_paths``
    by callers that check many batches of the same query.
    """
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    ok = np.ones(n, dtype=bool)
    if n == 0 or not query.edges:
        return ok
    bins = np.asarray(cluster.bins())

    # rule (2): along every logical edge, bins must be non-decreasing
    e_u = np.asarray([u for u, _ in query.edges])
    e_v = np.asarray([v for _, v in query.edges])
    ok &= (bins[assignments[:, e_u]] <= bins[assignments[:, e_v]]).all(axis=1)

    # rule (3): per root->sink path, no host revisited after being left.
    # With consecutive duplicates treated as staying put: hosts[i] == hosts[j]
    # (i < j) is a violation iff some hop between them changed host.
    for path in paths if paths is not None else query.root_to_sink_paths():
        hosts = assignments[:, path]  # (N, L)
        L = hosts.shape[1]
        if L < 3:
            continue  # a revisit needs at least leave + return
        changed = hosts[:, 1:] != hosts[:, :-1]  # (N, L-1)
        pref = np.concatenate(
            [np.zeros((n, 1), dtype=np.int64), np.cumsum(changed, axis=1)], axis=1
        )  # (N, L): #host-changes before position j
        same = hosts[:, :, None] == hosts[:, None, :]  # (N, L, L)
        moved_between = pref[:, None, :] > pref[:, :, None]  # (N, L, L): i -> j changed host
        upper = np.triu(np.ones((L, L), dtype=bool), k=2)  # pairs i < j-1
        ok &= ~(same & moved_between & upper).any(axis=(1, 2))
    return ok


def dedup_assignments(assignments: np.ndarray) -> np.ndarray:
    """Drop duplicate rows, preserving first-seen order."""
    if len(assignments) == 0:
        return assignments
    _, first = np.unique(assignments, axis=0, return_index=True)
    return assignments[np.sort(first)]


def sample_assignments(
    query: Query,
    cluster: Cluster,
    n: int,
    rng: np.random.Generator,
    colocation_bias: float = 0.4,
) -> np.ndarray:
    """Draw ``n`` placement candidates at once as an ``(n, n_ops)`` matrix.

    One vectorized pass per operator in topological order: every candidate
    picks uniformly among hosts whose bin is >= the max bin over its parents'
    hosts (rule 2 by construction along tree edges), with a ``colocation_bias``
    chance of reusing a random parent's host instead.  Co-location can still
    break rule 2 under multi-parent joins and rule 3 is not enforced during
    the sweep, so rows must be filtered with ``batch_validity_mask``.
    """
    bins = np.asarray(cluster.bins())
    # hosts sorted strongest-bin first: the hosts eligible for a minimum bin b
    # are exactly a prefix of this order, of length count_ge[b]
    order_desc = np.argsort(-bins, kind="stable")
    count_ge = np.asarray([(bins >= b).sum() for b in range(int(bins.max()) + 2)])

    assign = np.zeros((n, query.n_ops()), dtype=np.int64)
    for u in query.topological_order():
        parents = query.parents(u)
        if parents:
            min_bin = bins[assign[:, parents]].max(axis=1)  # (n,)
        else:
            min_bin = np.zeros(n, dtype=np.int64)
        n_opts = count_ge[min_bin]  # (n,) >= 1: the parent's own host qualifies
        pick = order_desc[(rng.random(n) * n_opts).astype(np.int64)]
        if parents:
            coloc = rng.random(n) < colocation_bias
            via = np.asarray(parents)[rng.integers(0, len(parents), size=n)]
            pick = np.where(coloc, assign[np.arange(n), via], pick)
        assign[:, u] = pick
    return assign


def sample_assignment_matrix(
    query: Query,
    cluster: Cluster,
    k: int,
    rng: np.random.Generator,
    max_tries_factor: int = 30,
    colocation_bias: float = 0.4,
) -> np.ndarray:
    """Up to ``k`` distinct valid assignments, shape ``(<=k, n_ops)``.

    Oversamples in vectorized rounds (draw -> validity mask -> dedup) until
    ``k`` candidates are collected or the tries budget — the same
    ``k * max_tries_factor`` total draws the old rejection loop allowed — is
    spent.
    """
    budget = k * max_tries_factor
    paths = query.root_to_sink_paths()
    pool = np.zeros((0, query.n_ops()), dtype=np.int64)
    while len(pool) < k and budget > 0:
        draw = min(max(2 * (k - len(pool)), 32), budget)
        budget -= draw
        batch = sample_assignments(query, cluster, draw, rng, colocation_bias)
        batch = batch[batch_validity_mask(query, cluster, batch, paths)]
        pool = dedup_assignments(np.concatenate([pool, batch], axis=0))
    return pool[:k]


def mutate_assignments(
    query: Query,
    cluster: Cluster,
    parents: np.ndarray,
    n_children_per: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """One-op host mutations of parent assignments, validity-filtered.

    Each parent row spawns ``n_children_per`` children with a single random
    operator moved to a random host; children violating the Fig.-5 rules are
    dropped and survivors deduplicated.  The refinement loop's move operator:
    cheap to generate in bulk, and every survivor re-enters the same batched
    scoring path as the initial candidates.
    """
    parents = np.asarray(parents, dtype=np.int64)
    if parents.size == 0 or n_children_per <= 0:
        return parents[:0]
    children = np.repeat(parents, n_children_per, axis=0)
    n = len(children)
    ops = rng.integers(0, query.n_ops(), size=n)
    children[np.arange(n), ops] = rng.integers(0, cluster.n_nodes(), size=n)
    children = children[batch_validity_mask(query, cluster, children)]
    return dedup_assignments(children)


