"""Heterogeneous hardware + network model (paper Table I hardware features).

Each compute node carries the four transferable hardware features the paper
uses: relative CPU capacity (% of a reference core), RAM, outgoing network
bandwidth and outgoing network latency (the paper configures these with
cgroups + tc-netem; here they are first-class attributes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.dsps import ranges


@dataclass(frozen=True)
class HardwareNode:
    node_id: int
    cpu: float  # % of a reference core (100 == one reference core)
    ram_mb: float
    bandwidth_mbps: float  # outgoing link bandwidth
    latency_ms: float  # outgoing link latency

    def cores(self) -> float:
        return self.cpu / 100.0


def hardware_bin(node: HardwareNode) -> int:
    """Classify hardware into three capability bins (paper Fig. 5 (2)).

    The paper intersects bins on their feature ranges to emulate realistic
    edge -> workstation -> cloud transitions; we score capability on log-scaled
    cpu+ram+bandwidth and cut the score range into three bins.
    """
    import math

    lo = (
        math.log(ranges.CPU[0]) + math.log(ranges.RAM_MB[0]) + math.log(ranges.BANDWIDTH_MBPS[0])
    )
    hi = (
        math.log(ranges.CPU[-1])
        + math.log(ranges.RAM_MB[-1])
        + math.log(ranges.BANDWIDTH_MBPS[-1])
    )
    score = math.log(max(node.cpu, 1e-9)) + math.log(max(node.ram_mb, 1e-9)) + math.log(
        max(node.bandwidth_mbps, 1e-9)
    )
    t = (score - lo) / max(hi - lo, 1e-9)
    if t < 1.0 / 3.0:
        return 0  # edge-class
    if t < 2.0 / 3.0:
        return 1  # workstation-class
    return 2  # cloud-class


@dataclass
class Cluster:
    """A set of heterogeneous nodes available for one query placement."""

    nodes: List[HardwareNode]

    def __post_init__(self):
        ids = [n.node_id for n in self.nodes]
        assert ids == sorted(ids) == list(range(len(ids))), "node_ids must be 0..n-1"

    def node(self, node_id: int) -> HardwareNode:
        return self.nodes[node_id]

    def n_nodes(self) -> int:
        return len(self.nodes)

    def bins(self) -> List[int]:
        return [hardware_bin(n) for n in self.nodes]

    def link(self, src: int, dst: int) -> Tuple[float, float]:
        """(bandwidth_mbps, latency_ms) of the src->dst link.

        The paper models per-host *outgoing* bandwidth/latency (netem on the
        sender); a transfer is additionally capped by the receiver's ingress.
        """
        if src == dst:
            return (float("inf"), 0.0)
        s, d = self.node(src), self.node(dst)
        return (min(s.bandwidth_mbps, d.bandwidth_mbps), s.latency_ms)

    def mean_features(self) -> Dict[str, float]:
        n = max(len(self.nodes), 1)
        return {
            "cpu": sum(x.cpu for x in self.nodes) / n,
            "ram_mb": sum(x.ram_mb for x in self.nodes) / n,
            "bandwidth_mbps": sum(x.bandwidth_mbps for x in self.nodes) / n,
            "latency_ms": sum(x.latency_ms for x in self.nodes) / n,
        }
