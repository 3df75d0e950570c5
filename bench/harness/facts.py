"""What the count functions read: the shape of each call's work, from the benchmark's own inputs.

``Facts`` describe a set of graphs by their real rows only (no padding, no trimmed layout):
operators and hosts per graph, and per depth level the operators updated there and the data-flow
edges into them.  They come from the reference's featurization of the inputs that the benchmark
handed to the program, never from the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bench.reference.featurize import MAX_DEPTH, Graphs


@dataclass
class Facts:
    n_ops: np.ndarray  # (n,) real operators
    n_hw: np.ndarray  # (n,) real hosts
    depth_rows: np.ndarray  # (n, MAX_DEPTH + 1) operators at each depth
    depth_edges: np.ndarray  # (n, MAX_DEPTH + 1) data-flow edges into the operators at each depth

    def take(self, idx) -> "Facts":
        return Facts(self.n_ops[idx], self.n_hw[idx], self.depth_rows[idx], self.depth_edges[idx])


def of_graphs(g: Graphs) -> Facts:
    real = g.op_mask > 0
    depth = np.where(real, g.op_depth, -1)
    indeg = g.a_flow.sum(axis=1)  # (B, 12): parents of each row
    rows = np.stack([(depth == d).sum(1) for d in range(MAX_DEPTH + 1)], 1)
    edges = np.stack([np.where(depth == d, indeg, 0).sum(1) for d in range(MAX_DEPTH + 1)], 1)
    return Facts(real.sum(1).astype(np.int64), (g.hw_mask > 0).sum(1).astype(np.int64),
                 rows.astype(np.int64), edges.astype(np.int64))


@dataclass
class CallWork:
    """One call's work: ``rows`` per answered graph or candidate; ``stage0`` per graph whose
    placement-invariant encodings the call needs once (every graph of an estimation call; each
    distinct structure of a scoring call)."""

    entry: str
    rows: Facts
    stage0: Facts
    members: int
    hidden: int
