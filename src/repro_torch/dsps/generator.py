"""Benchmark workload generator (paper SVI + Table II).

Generates the cost-estimation corpus: random streaming queries (linear filter
chains, 2-way and 3-way joins at approximately 35/34/31 %), random
heterogeneous clusters, and placements, then labels them with the simulator.
Everything is reproducible from integer seeds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dsps import ranges
from repro_torch.dsps.hardware import Cluster, HardwareNode
from repro_torch.dsps.placement import Placement
from repro_torch.dsps.query import (
    AggFn,
    DType,
    FilterFn,
    Operator,
    OpType,
    Query,
    WindowSpec,
)
from repro_torch.dsps.simulator import CostLabels, SimulatorConfig, simulate


@dataclass(frozen=True)
class Trace:
    """One corpus entry: a placed query with its measured cost labels."""

    query: Query
    cluster: Cluster
    placement: Placement
    labels: CostLabels


@dataclass(frozen=True)
class GeneratorConfig:
    """Sampling ranges; defaults mirror Table II exactly."""

    cpu: Sequence[float] = tuple(ranges.CPU)
    ram_mb: Sequence[float] = tuple(ranges.RAM_MB)
    bandwidth_mbps: Sequence[float] = tuple(ranges.BANDWIDTH_MBPS)
    latency_ms: Sequence[float] = tuple(ranges.LATENCY_MS)
    event_rate_linear: Sequence[float] = tuple(ranges.EVENT_RATE_LINEAR)
    event_rate_two_way: Sequence[float] = tuple(ranges.EVENT_RATE_TWO_WAY)
    event_rate_three_way: Sequence[float] = tuple(ranges.EVENT_RATE_THREE_WAY)
    tuple_widths: Sequence[int] = tuple(ranges.TUPLE_WIDTHS)
    window_size_count: Sequence[float] = tuple(ranges.WINDOW_SIZE_COUNT)
    window_size_time: Sequence[float] = tuple(ranges.WINDOW_SIZE_TIME)
    filter_count_p: Tuple[Tuple[int, float], ...] = tuple(ranges.FILTER_COUNT_P.items())
    agg_probability: float = ranges.AGG_PROBABILITY
    query_mix: Tuple[Tuple[str, float], ...] = tuple(ranges.QUERY_MIX.items())
    n_hosts: Tuple[int, int] = (3, 8)
    max_filters_per_chain: int = 4  # training corpus uses 1 (Exp 5 uses 2..4)
    filters_per_chain: int = 1
    sim: SimulatorConfig = SimulatorConfig()

    def with_hardware(self, **kw) -> "GeneratorConfig":
        return replace(self, **kw)


class WorkloadGenerator:
    def __init__(self, config: GeneratorConfig = GeneratorConfig(), seed: int = 0):
        self.config = config
        self.rng = np.random.default_rng(seed)

    # -- sampling helpers ------------------------------------------------------
    def _choice(self, seq: Sequence) -> object:
        return seq[int(self.rng.integers(0, len(seq)))]

    def _dtype(self, allow_none: bool = False) -> DType:
        opts = [DType.INT, DType.DOUBLE, DType.STRING] + ([DType.NONE] if allow_none else [])
        return opts[int(self.rng.integers(0, len(opts)))]

    def _window(self) -> WindowSpec:
        policy = str(self._choice(ranges.WINDOW_POLICIES))
        wtype = str(self._choice(ranges.WINDOW_TYPES))
        if policy == "count":
            size = float(self._choice(self.config.window_size_count))
        else:
            size = float(self._choice(self.config.window_size_time))
        lo, hi = ranges.SLIDE_RATIO
        slide = float(self.rng.uniform(lo, hi))
        return WindowSpec(wtype=wtype, policy=policy, size=size, slide_ratio=slide)

    def _loguniform(self, lo10: float, hi10: float) -> float:
        return float(10.0 ** self.rng.uniform(lo10, hi10))

    def _source(self, op_id: int, rate_pool: Sequence[float]) -> Operator:
        width = int(self._choice(self.config.tuple_widths))
        # random attribute type mix
        kinds = self.rng.multinomial(width, [1 / 3] * 3)
        return Operator(
            op_id=op_id,
            op_type=OpType.SOURCE,
            event_rate=float(self._choice(rate_pool)),
            n_int=int(kinds[0]),
            n_double=int(kinds[1]),
            n_string=int(kinds[2]),
        )

    def _filter(self, op_id: int) -> Operator:
        fn = FilterFn(str(self._choice(ranges.FILTER_FNS)))
        if fn in (FilterFn.STARTSWITH, FilterFn.ENDSWITH):
            lit = DType.STRING
        else:
            lit = DType(str(self._choice(["int", "double"])))
        return Operator(
            op_id=op_id,
            op_type=OpType.FILTER,
            filter_fn=fn,
            literal_dtype=lit,
            selectivity=self._loguniform(*ranges.FILTER_SEL_LOG10),
        )

    def _agg(self, op_id: int) -> Operator:
        gb = self._dtype(allow_none=True)
        return Operator(
            op_id=op_id,
            op_type=OpType.AGGREGATE,
            agg_fn=AggFn(str(self._choice(ranges.AGG_FNS))),
            group_by_dtype=gb,
            agg_dtype=DType(str(self._choice(["int", "double"]))),
            window=self._window(),
            selectivity=(
                self._loguniform(*ranges.AGG_SEL_LOG10) if gb != DType.NONE else 1.0
            ),
        )

    def _join(self, op_id: int) -> Operator:
        return Operator(
            op_id=op_id,
            op_type=OpType.JOIN,
            join_key_dtype=self._dtype(),
            window=self._window(),
            selectivity=self._loguniform(*ranges.JOIN_SEL_LOG10),
        )

    def _sink(self, op_id: int) -> Operator:
        return Operator(op_id=op_id, op_type=OpType.SINK)

    def _n_filters(self) -> int:
        counts, probs = zip(*self.config.filter_count_p)
        probs = np.asarray(probs, dtype=np.float64)
        probs = probs / probs.sum()
        return int(self.rng.choice(counts, p=probs))

    # -- query templates ---------------------------------------------------------
    def query(self, kind: Optional[str] = None, name: str = "q") -> Query:
        if kind is None:
            kinds, probs = zip(*self.config.query_mix)
            probs = np.asarray(probs, dtype=np.float64)
            kind = str(self.rng.choice(kinds, p=probs / probs.sum()))
        if kind == "linear":
            return self.linear_query(name=name)
        if kind == "two_way":
            return self.join_query(n_streams=2, name=name)
        if kind == "three_way":
            return self.join_query(n_streams=3, name=name)
        raise ValueError(kind)

    def linear_query(self, name: str = "q", n_filters: Optional[int] = None) -> Query:
        """source -> filter+ -> [agg] -> sink (paper: linear filter queries).

        Training corpora use chains of length ``config.filters_per_chain``
        (default 1 — the paper's training data "has only seen 1 subsequent
        filter operator"); Exp 5 passes ``n_filters`` = 2..4 explicitly to
        build the *unseen* longer chains.
        """
        ops: List[Operator] = []
        edges: List[Tuple[int, int]] = []
        ops.append(self._source(0, self.config.event_rate_linear))
        prev = 0
        nf = self.config.filters_per_chain if n_filters is None else n_filters
        nf = max(1, min(nf, self.config.max_filters_per_chain))
        for _ in range(nf):
            ops.append(self._filter(len(ops)))
            edges.append((prev, len(ops) - 1))
            prev = len(ops) - 1
        if self.rng.random() < self.config.agg_probability:
            ops.append(self._agg(len(ops)))
            edges.append((prev, len(ops) - 1))
            prev = len(ops) - 1
        ops.append(self._sink(len(ops)))
        edges.append((prev, len(ops) - 1))
        return Query(operators=ops, edges=edges, name=name).infer_widths()

    def join_query(self, n_streams: int = 2, name: str = "q") -> Query:
        """n sources -> [filters] -> join tree -> [agg] -> sink (paper Fig. 6)."""
        assert n_streams in (2, 3)
        pool = (
            self.config.event_rate_two_way
            if n_streams == 2
            else self.config.event_rate_three_way
        )
        ops: List[Operator] = []
        edges: List[Tuple[int, int]] = []
        heads: List[int] = []
        budget = self._n_filters()
        for s in range(n_streams):
            ops.append(self._source(len(ops), pool))
            head = len(ops) - 1
            # optional filter on this stream
            if budget > 0 and self.rng.random() < 0.6:
                ops.append(self._filter(len(ops)))
                edges.append((head, len(ops) - 1))
                head = len(ops) - 1
                budget -= 1
            heads.append(head)
        # left-deep join tree
        left = heads[0]
        for s in range(1, n_streams):
            ops.append(self._join(len(ops)))
            j = len(ops) - 1
            edges.append((left, j))
            edges.append((heads[s], j))
            left = j
        # spend remaining filter budget after the join (never consecutively:
        # chains of >1 filter are reserved for the unseen-pattern experiment)
        if budget > 0 and self.rng.random() < 0.5:
            ops.append(self._filter(len(ops)))
            edges.append((left, len(ops) - 1))
            left = len(ops) - 1
        if self.rng.random() < self.config.agg_probability:
            ops.append(self._agg(len(ops)))
            edges.append((left, len(ops) - 1))
            left = len(ops) - 1
        ops.append(self._sink(len(ops)))
        edges.append((left, len(ops) - 1))
        return Query(operators=ops, edges=edges, name=name).infer_widths()

    # -- hardware ----------------------------------------------------------------
    def cluster(self, n_hosts: Optional[int] = None) -> Cluster:
        lo, hi = self.config.n_hosts
        n = int(self.rng.integers(lo, hi + 1)) if n_hosts is None else n_hosts
        nodes = [
            HardwareNode(
                node_id=i,
                cpu=float(self._choice(self.config.cpu)),
                ram_mb=float(self._choice(self.config.ram_mb)),
                bandwidth_mbps=float(self._choice(self.config.bandwidth_mbps)),
                latency_ms=float(self._choice(self.config.latency_ms)),
            )
            for i in range(n)
        ]
        return Cluster(nodes=nodes)

    # -- placement ----------------------------------------------------------------
    def placement(self, query: Query, cluster: Cluster) -> Placement:
        """Random placement with a mild co-location bias (training diversity).

        The corpus intentionally includes bad placements (overload, OOM,
        network-saturated) so the model learns backpressure/failure modes.
        """
        n = cluster.n_nodes()
        assign: List[int] = [0] * query.n_ops()
        for op in query.operators:
            if op.op_type == OpType.SOURCE or self.rng.random() < 0.35:
                assign[op.op_id] = int(self.rng.integers(0, n))
            else:
                # follow a parent's host (co-location) or pick fresh
                parents = query.parents(op.op_id)
                if parents and self.rng.random() < 0.5:
                    assign[op.op_id] = assign[parents[0]]
                else:
                    assign[op.op_id] = int(self.rng.integers(0, n))
        return Placement.of(assign)

    # -- corpus ---------------------------------------------------------------------
    def trace(self, kind: Optional[str] = None, name: str = "q") -> Trace:
        q = self.query(kind=kind, name=name)
        c = self.cluster()
        p = self.placement(q, c)
        labels = simulate(q, c, p, self.config.sim, rng=self.rng)
        return Trace(query=q, cluster=c, placement=p, labels=labels)

    def corpus(self, n: int, name_prefix: str = "q") -> List[Trace]:
        return [self.trace(name=f"{name_prefix}{i}") for i in range(n)]
