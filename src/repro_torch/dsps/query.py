"""Streaming query IR: a DAG of algebraic streaming operators.

Mirrors the paper's operator model (SIII-A): source / filter / windowed
aggregation / windowed join / sink, with the transferable operator- and
data-related features of Table I attached to each operator node.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple


class OpType(str, Enum):
    SOURCE = "source"
    FILTER = "filter"
    AGGREGATE = "aggregate"
    JOIN = "join"
    SINK = "sink"


class DType(str, Enum):
    INT = "int"
    DOUBLE = "double"
    STRING = "string"
    NONE = "none"  # only valid for group-by


class FilterFn(str, Enum):
    LT = "<"
    GT = ">"
    LE = "<="
    GE = ">="
    NE = "!="
    STARTSWITH = "startswith"
    ENDSWITH = "endswith"


class AggFn(str, Enum):
    MIN = "min"
    MAX = "max"
    MEAN = "mean"
    SUM = "sum"


@dataclass(frozen=True)
class WindowSpec:
    """Window configuration for stateful operators (join / aggregation)."""

    wtype: str = "tumbling"  # sliding | tumbling
    policy: str = "count"  # count | time
    size: float = 10.0  # tuples (count) or seconds (time)
    slide_ratio: float = 0.5  # sliding interval as a fraction of the size

    def __post_init__(self):
        assert self.wtype in ("sliding", "tumbling"), self.wtype
        assert self.policy in ("count", "time"), self.policy
        assert self.size > 0, self.size
        assert 0.0 < self.slide_ratio <= 1.0, self.slide_ratio

    def slide(self) -> float:
        """Effective slide: tumbling windows slide by one full window."""
        return self.size if self.wtype == "tumbling" else self.size * self.slide_ratio

    def length_tuples(self, rate: float) -> float:
        """Window length in tuples given the incoming tuple rate [ev/s]."""
        if self.policy == "count":
            return float(self.size)
        return max(1.0, float(self.size) * max(rate, 1e-9))

    def period_seconds(self, rate: float) -> float:
        """Time between window emissions given the incoming rate [ev/s]."""
        slide = self.slide()
        if self.policy == "time":
            return float(slide)
        return float(slide) / max(rate, 1e-9)


@dataclass
class Operator:
    """One streaming operator with its Table-I transferable features.

    Only the fields relevant to ``op_type`` are meaningful; the featurizer
    masks the rest. ``tuple_width_in/out`` are derived by ``Query.infer_widths``.
    """

    op_id: int
    op_type: OpType
    # data-related (all nodes)
    tuple_width_in: float = 0.0
    tuple_width_out: float = 0.0
    # source
    event_rate: float = 0.0
    n_int: int = 0
    n_double: int = 0
    n_string: int = 0
    # filter
    filter_fn: Optional[FilterFn] = None
    literal_dtype: Optional[DType] = None
    # join
    join_key_dtype: Optional[DType] = None
    # aggregation
    agg_fn: Optional[AggFn] = None
    group_by_dtype: Optional[DType] = None
    agg_dtype: Optional[DType] = None
    # stateful ops
    window: Optional[WindowSpec] = None
    # filter/join/agg
    selectivity: float = 1.0

    def is_stateful(self) -> bool:
        return self.op_type in (OpType.AGGREGATE, OpType.JOIN)

    def replace(self, **kw) -> "Operator":
        return dataclasses.replace(self, **kw)


@dataclass
class Query:
    """A streaming query: operators + logical data-flow edges (a DAG).

    Convention: exactly one sink; sources have no parents; the DAG is a tree
    oriented towards the sink (paper SIII-A: "the logical data flow is not
    always linear but can take the form of a tree").
    """

    operators: List[Operator]
    edges: List[Tuple[int, int]]  # (upstream op_id, downstream op_id)
    name: str = "query"

    def __post_init__(self):
        ids = [op.op_id for op in self.operators]
        assert ids == sorted(ids) == list(range(len(ids))), "op_ids must be 0..n-1"
        for u, v in self.edges:
            assert 0 <= u < len(ids) and 0 <= v < len(ids), (u, v)
        assert len(self.sinks()) == 1, "exactly one sink expected"
        self._validate_acyclic()

    # -- structure ------------------------------------------------------------
    def op(self, op_id: int) -> Operator:
        return self.operators[op_id]

    def children(self, op_id: int) -> List[int]:
        return [v for (u, v) in self.edges if u == op_id]

    def parents(self, op_id: int) -> List[int]:
        return [u for (u, v) in self.edges if v == op_id]

    def sources(self) -> List[int]:
        return [op.op_id for op in self.operators if op.op_type == OpType.SOURCE]

    def sinks(self) -> List[int]:
        return [op.op_id for op in self.operators if op.op_type == OpType.SINK]

    def sink(self) -> int:
        return self.sinks()[0]

    def _validate_acyclic(self) -> None:
        order = self.topological_order()
        assert len(order) == len(self.operators), "data-flow graph has a cycle"

    def topological_order(self) -> List[int]:
        indeg: Dict[int, int] = {op.op_id: 0 for op in self.operators}
        for _, v in self.edges:
            indeg[v] += 1
        frontier = [i for i, d in sorted(indeg.items()) if d == 0]
        order: List[int] = []
        while frontier:
            u = frontier.pop(0)
            order.append(u)
            for v in self.children(u):
                indeg[v] -= 1
                if indeg[v] == 0:
                    frontier.append(v)
        return order

    def depths(self) -> Dict[int, int]:
        """Topological depth (longest distance from any source)."""
        depth: Dict[int, int] = {}
        for u in self.topological_order():
            ps = self.parents(u)
            depth[u] = 0 if not ps else 1 + max(depth[p] for p in ps)
        return depth

    def root_to_sink_paths(self) -> List[List[int]]:
        """All source->sink op-id paths (the units of the paper's Fig.-5
        acyclicity rule: once data leaves a host it must never return)."""
        sink = self.sink()

        def walk(u: int) -> List[List[int]]:
            if u == sink:
                return [[u]]
            out = []
            for v in self.children(u):
                for p in walk(v):
                    out.append([u] + p)
            return out

        paths: List[List[int]] = []
        for src in self.sources():
            paths.extend(walk(src))
        return paths

    def max_depth(self) -> int:
        return max(self.depths().values()) if self.operators else 0

    # -- feature derivation -----------------------------------------------------
    def infer_widths(self) -> "Query":
        """Derive tuple widths through the data flow (in topological order).

        source: width = #attributes; filter: pass-through; join: sum of both
        input widths; aggregation: (group key + aggregate value) or 1; sink:
        pass-through.
        """
        width: Dict[int, float] = {}
        for u in self.topological_order():
            op = self.op(u)
            pw = [width[p] for p in self.parents(u)]
            if op.op_type == OpType.SOURCE:
                w_in = float(op.n_int + op.n_double + op.n_string)
                w_out = w_in
            elif op.op_type == OpType.FILTER:
                w_in = pw[0]
                w_out = w_in
            elif op.op_type == OpType.JOIN:
                w_in = sum(pw)
                w_out = sum(pw)
            elif op.op_type == OpType.AGGREGATE:
                w_in = pw[0]
                w_out = 2.0 if (op.group_by_dtype not in (None, DType.NONE)) else 1.0
            else:  # SINK
                w_in = pw[0]
                w_out = pw[0]
            op.tuple_width_in = w_in
            op.tuple_width_out = w_out
            width[u] = w_out
        return self

    # -- stats -----------------------------------------------------------------
    def count(self, op_type: OpType) -> int:
        return sum(1 for op in self.operators if op.op_type == op_type)

    def n_ops(self) -> int:
        return len(self.operators)

    def describe(self) -> str:
        parts = []
        for op in self.operators:
            parts.append(f"{op.op_id}:{op.op_type.value}")
        edges = ",".join(f"{u}->{v}" for u, v in self.edges)
        return f"Query<{self.name}|{' '.join(parts)}|{edges}>"


def linear_chain(operators: Sequence[Operator], name: str = "query") -> Query:
    """Convenience builder: operators wired in a straight chain."""
    ops = list(operators)
    edges = [(i, i + 1) for i in range(len(ops) - 1)]
    return Query(operators=ops, edges=edges, name=name).infer_widths()
