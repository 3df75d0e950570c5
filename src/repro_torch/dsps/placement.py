"""Operator placement: the mapping omega_i -> n_j (paper SIII-A)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.dsps.hardware import Cluster, hardware_bin
from repro_torch.dsps.query import Query


@dataclass(frozen=True)
class Placement:
    """assignment[op_id] = node_id for every operator of a query."""

    assignment: Tuple[int, ...]

    @staticmethod
    def of(mapping: Sequence[int]) -> "Placement":
        return Placement(assignment=tuple(int(x) for x in mapping))

    def node_of(self, op_id: int) -> int:
        return self.assignment[op_id]

    def colocated(self, op_a: int, op_b: int) -> bool:
        return self.assignment[op_a] == self.assignment[op_b]

    def used_nodes(self) -> List[int]:
        return sorted(set(self.assignment))

    def ops_on(self, node_id: int) -> List[int]:
        return [i for i, n in enumerate(self.assignment) if n == node_id]

    def validate(self, query: Query, cluster: Cluster) -> None:
        assert len(self.assignment) == query.n_ops(), (
            f"placement covers {len(self.assignment)} ops, query has {query.n_ops()}"
        )
        for node in self.assignment:
            assert 0 <= node < cluster.n_nodes(), node


def physical_hops(query: Query, placement: Placement) -> List[Tuple[int, int]]:
    """Data-flow edges that cross host boundaries (physical data flow)."""
    hops = []
    for u, v in query.edges:
        nu, nv = placement.node_of(u), placement.node_of(v)
        if nu != nv:
            hops.append((nu, nv))
    return hops


def respects_increasing_capability(
    query: Query, cluster: Cluster, placement: Placement
) -> bool:
    """Fig. 5 (2): data flows only from same-or-weaker to stronger bins."""
    bins = cluster.bins()
    for u, v in query.edges:
        if bins[placement.node_of(u)] > bins[placement.node_of(v)]:
            return False
    return True


def is_acyclic_placement(query: Query, placement: Placement) -> bool:
    """Fig. 5 (3): once data leaves a host it must never return to it.

    Checked per root-to-sink path over the sequence of visited hosts.
    """
    for path in query.root_to_sink_paths():
        hosts = [placement.node_of(op) for op in path]
        seen: list[int] = []
        for h in hosts:
            if seen and h == seen[-1]:
                continue
            if h in seen:
                return False
            seen.append(h)
    return True
