"""The benchmark's own workload generator: streaming queries, clusters and placements from a seed.

A frozen copy of the sampling rules of the port's ``dsps/{ranges,generator,benchmarks}.py`` and
``placement/enumerate.py`` (the paper's Table II workload space, the DSPBench / DEBS'14 queries of
its Sec. VII-F and the Fig. 5 placement rules), written over the benchmark's own plain types so that
no change to the program can move what the benchmark asks of it.  ``program.py`` turns these types
into the program's; ``reference/featurize.py`` featurizes them without the program.

Every query and cluster takes two streams of draws (``Draws``): ``shape`` decides a query's operators and edges and a cluster's
host count and capability bins, ``feat`` decides the numbers inside them (rates, widths, windows,
selectivities, host values).  A traffic mix that must give every seed the same work (the scoring
mixes) draws shapes from a fixed seed and numbers from the run's seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --- paper Table II ----------------------------------------------------------------------------
CPU = (50, 100, 200, 300, 400, 500, 600, 700, 800)  # % of a reference core
RAM_MB = (1000, 2000, 4000, 8000, 16000, 24000, 32000)
BANDWIDTH_MBPS = (25, 50, 100, 200, 400, 800, 1600, 3200, 6400, 10000)
LATENCY_MS = (1, 2, 5, 10, 20, 40, 80, 160)
EVENT_RATE = {
    "linear": (100, 200, 400, 800, 1600, 3200, 6400, 12800, 25600),
    "two_way": (50, 100, 250, 500, 750, 1000, 1250, 1500, 1750, 2000),
    "three_way": (20, 50, 100, 200, 300, 400, 500, 600, 700, 800, 900, 1000),
}
TUPLE_WIDTHS = tuple(range(3, 11))
FILTER_FNS = ("<", ">", "<=", ">=", "!=", "startswith", "endswith")
WINDOW_TYPES = ("sliding", "tumbling")
WINDOW_POLICIES = ("count", "time")
WINDOW_SIZE_COUNT = (5, 10, 20, 40, 80, 160, 320, 640)
WINDOW_SIZE_TIME = (0.25, 0.5, 1, 2, 4, 8, 16)
SLIDE_RATIO = (0.3, 0.7)
AGG_FNS = ("min", "max", "mean", "sum")
FILTER_SEL_LOG10 = (-2.0, 0.0)
JOIN_SEL_LOG10 = (-3.0, -0.5)
AGG_SEL_LOG10 = (-2.0, 0.0)
QUERY_MIX = (("linear", 0.35), ("two_way", 0.34), ("three_way", 0.31))
FILTER_COUNT_P = ((1, 0.35), (2, 0.34), (3, 0.24), (4, 0.06))
AGG_PROBABILITY = 0.5
FILTERS_PER_CHAIN = 1  # the training corpus's linear chains (paper Sec. VI)
N_HOSTS = (3, 8)


@dataclass(frozen=True)
class Window:
    wtype: str
    policy: str
    size: float
    slide_ratio: float


@dataclass(frozen=True)
class Op:
    """One operator: ``kind`` is source / filter / aggregate / join / sink."""

    kind: str
    width_in: float = 0.0
    width_out: float = 0.0
    event_rate: float = 0.0
    n_int: int = 0
    n_double: int = 0
    n_string: int = 0
    filter_fn: Optional[str] = None
    literal_dtype: Optional[str] = None
    join_key_dtype: Optional[str] = None
    agg_fn: Optional[str] = None
    group_by_dtype: Optional[str] = None
    agg_dtype: Optional[str] = None
    window: Optional[Window] = None
    selectivity: float = 1.0


@dataclass(frozen=True)
class Query:
    ops: Tuple[Op, ...]
    edges: Tuple[Tuple[int, int], ...]  # (upstream, downstream) op indices
    name: str = "q"

    def parents(self, v: int) -> List[int]:
        return [a for a, b in self.edges if b == v]

    def children(self, u: int) -> List[int]:
        return [b for a, b in self.edges if a == u]

    def topological_order(self) -> List[int]:
        indeg = [0] * len(self.ops)
        for _, v in self.edges:
            indeg[v] += 1
        frontier = [i for i in range(len(self.ops)) if indeg[i] == 0]
        order = []
        while frontier:
            u = frontier.pop(0)
            order.append(u)
            for v in self.children(u):
                indeg[v] -= 1
                if indeg[v] == 0:
                    frontier.append(v)
        return order

    def depths(self) -> List[int]:
        depth = [0] * len(self.ops)
        for u in self.topological_order():
            ps = self.parents(u)
            depth[u] = 1 + max(depth[p] for p in ps) if ps else 0
        return depth

    def root_to_sink_paths(self) -> List[List[int]]:
        sink = next(i for i, op in enumerate(self.ops) if op.kind == "sink")

        def walk(u):
            if u == sink:
                return [[u]]
            return [[u] + p for v in self.children(u) for p in walk(v)]

        return [p for s, op in enumerate(self.ops) if op.kind == "source" for p in walk(s)]


@dataclass(frozen=True)
class Host:
    cpu: float
    ram_mb: float
    bandwidth_mbps: float
    latency_ms: float


Cluster = Tuple[Host, ...]


@dataclass(frozen=True)
class Trace:
    """A placed query: ``assignment[i]`` is the host of operator ``i``."""

    query: Query
    cluster: Cluster
    assignment: Tuple[int, ...]


# --- draws ------------------------------------------------------------------------------------


class Draws:
    """A seeded stream of uniforms in [0, 1), drawn from NumPy in blocks, and the draws built on
    it: the per-operator sampling calls thousands of small draws, which NumPy's scalar calls make
    slow."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._buf = np.empty(0)
        self._i = 0

    def random(self) -> float:
        if self._i >= self._buf.size:
            self._buf, self._i = self._rng.random(4096), 0
        self._i += 1
        return float(self._buf[self._i - 1])

    def integers(self, lo: int, hi: int) -> int:
        """Uniform in ``[lo, hi)``."""
        return lo + min(int(self.random() * (hi - lo)), hi - lo - 1)

    def uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.random()

    def choice(self, seq: Sequence, p=None):
        if p is None:
            return seq[self.integers(0, len(seq))]
        u, acc = self.random() * float(sum(p)), 0.0
        for x, w in zip(seq, p):
            acc += w
            if u < acc:
                return x
        return seq[-1]


# --- widths through the data flow (the program's Query.infer_widths rule) ---------------------


def with_widths(ops: List[Op], edges: List[Tuple[int, int]], name: str) -> Query:
    q = Query(tuple(ops), tuple(edges), name)
    width: Dict[int, float] = {}
    out = list(ops)
    for u in q.topological_order():
        op = ops[u]
        pw = [width[p] for p in q.parents(u)]
        if op.kind == "source":
            w_in = w_out = float(op.n_int + op.n_double + op.n_string)
        elif op.kind == "join":
            w_in = w_out = sum(pw)
        elif op.kind == "aggregate":
            w_in = pw[0]
            w_out = 2.0 if op.group_by_dtype not in (None, "none") else 1.0
        else:  # filter, sink: pass-through
            w_in = w_out = pw[0]
        out[u] = _replace(op, width_in=w_in, width_out=w_out)
        width[u] = w_out
    return Query(tuple(out), tuple(edges), name)


def _replace(op: Op, **kw) -> Op:
    d = dict(op.__dict__)
    d.update(kw)
    return Op(**d)


# --- operators -------------------------------------------------------------------------------


def _loguniform(rng: Draws, lo10: float, hi10: float) -> float:
    return float(10.0 ** rng.uniform(lo10, hi10))


def _window(feat: Draws) -> Window:
    policy = str(feat.choice(WINDOW_POLICIES))
    wtype = str(feat.choice(WINDOW_TYPES))
    size = float(feat.choice(WINDOW_SIZE_COUNT if policy == "count" else WINDOW_SIZE_TIME))
    return Window(wtype, policy, size, float(feat.uniform(*SLIDE_RATIO)))


def _dtype(feat: Draws, allow_none: bool = False) -> str:
    return feat.choice(("int", "double", "string") + (("none",) if allow_none else ()))


def _source(feat: Draws, rates: Sequence[float]) -> Op:
    width = int(feat.choice(TUPLE_WIDTHS))
    kinds = [0, 0, 0]  # each attribute an int, a double or a string, with equal odds
    for _ in range(width):
        kinds[feat.integers(0, 3)] += 1
    return Op("source", event_rate=float(feat.choice(rates)), n_int=int(kinds[0]),
              n_double=int(kinds[1]), n_string=int(kinds[2]))


def _filter(feat: Draws) -> Op:
    fn = str(feat.choice(FILTER_FNS))
    lit = "string" if fn in ("startswith", "endswith") else str(feat.choice(("int", "double")))
    return Op("filter", filter_fn=fn, literal_dtype=lit, selectivity=_loguniform(feat, *FILTER_SEL_LOG10))


def _agg(feat: Draws) -> Op:
    gb = _dtype(feat, allow_none=True)
    return Op("aggregate", agg_fn=str(feat.choice(AGG_FNS)), group_by_dtype=gb,
              agg_dtype=str(feat.choice(("int", "double"))), window=_window(feat),
              selectivity=_loguniform(feat, *AGG_SEL_LOG10) if gb != "none" else 1.0)


def _join(feat: Draws) -> Op:
    return Op("join", join_key_dtype=_dtype(feat), window=_window(feat),
              selectivity=_loguniform(feat, *JOIN_SEL_LOG10))


# --- synthetic queries (paper Sec. VI, Table II) ---------------------------------------------


def synthetic_query(kind: str, shape: Draws, feat: Draws, name: str = "q") -> Query:
    """A linear filter query or a 2- or 3-way join tree, as the paper's corpus draws them."""
    ops: List[Op] = []
    edges: List[Tuple[int, int]] = []
    if kind == "linear":
        ops.append(_source(feat, EVENT_RATE["linear"]))
        prev = 0
        for _ in range(FILTERS_PER_CHAIN):
            ops.append(_filter(feat))
            edges.append((prev, len(ops) - 1))
            prev = len(ops) - 1
        if shape.random() < AGG_PROBABILITY:
            ops.append(_agg(feat))
            edges.append((prev, len(ops) - 1))
            prev = len(ops) - 1
        ops.append(Op("sink"))
        edges.append((prev, len(ops) - 1))
        return with_widths(ops, edges, name)
    n_streams = {"two_way": 2, "three_way": 3}[kind]
    counts, p = zip(*FILTER_COUNT_P)
    budget = int(shape.choice(counts, p))
    heads = []
    for _ in range(n_streams):
        ops.append(_source(feat, EVENT_RATE[kind]))
        head = len(ops) - 1
        if budget > 0 and shape.random() < 0.6:
            ops.append(_filter(feat))
            edges.append((head, len(ops) - 1))
            head = len(ops) - 1
            budget -= 1
        heads.append(head)
    left = heads[0]
    for s in range(1, n_streams):  # left-deep join tree
        ops.append(_join(feat))
        j = len(ops) - 1
        edges += [(left, j), (heads[s], j)]
        left = j
    if budget > 0 and shape.random() < 0.5:
        ops.append(_filter(feat))
        edges.append((left, len(ops) - 1))
        left = len(ops) - 1
    if shape.random() < AGG_PROBABILITY:
        ops.append(_agg(feat))
        edges.append((left, len(ops) - 1))
        left = len(ops) - 1
    ops.append(Op("sink"))
    edges.append((left, len(ops) - 1))
    return with_widths(ops, edges, name)


# --- the DSPBench / DEBS'14 queries (paper Sec. VII-F, Table VI (B)) ---------------------------


def _advertisement(feat: Draws) -> Query:
    ops = [
        Op("source", event_rate=float(feat.choice([100, 200, 400, 800, 1600])), n_int=2, n_string=2),
        Op("source", event_rate=float(feat.choice([200, 400, 800, 1600, 3200])), n_int=3, n_string=3),
        Op("filter", filter_fn="!=", literal_dtype="string", selectivity=0.82),
        Op("join", join_key_dtype="string", window=Window("sliding", "time", 4.0, 0.5), selectivity=0.004),
        Op("sink"),
    ]
    return with_widths(ops, [(0, 3), (1, 2), (2, 3), (3, 4)], "advertisement")


def _spike_detection(feat: Draws) -> Query:
    ops = [
        Op("source", event_rate=float(feat.choice([400, 800, 1600, 3200, 6400, 12800])), n_int=1, n_double=3),
        Op("aggregate", agg_fn="mean", group_by_dtype="int", agg_dtype="double",
           window=Window("sliding", "count", 90.0, 0.34), selectivity=0.06),
        Op("filter", filter_fn=">", literal_dtype="double", selectivity=0.03),
        Op("sink"),
    ]
    return with_widths(ops, [(0, 1), (1, 2), (2, 3)], "spike_detection")


def _smart_grid_global(feat: Draws) -> Query:
    ops = [
        Op("source", event_rate=float(feat.choice([400, 800, 1600, 3200, 6400])), n_int=4, n_double=2),
        Op("aggregate", agg_fn="sum", group_by_dtype="none", agg_dtype="double",
           window=Window("sliding", "time", 30.0, 0.4), selectivity=1.0),
        Op("sink"),
    ]
    return with_widths(ops, [(0, 1), (1, 2)], "smart_grid_global")


def _smart_grid_local(feat: Draws) -> Query:
    ops = [
        Op("source", event_rate=float(feat.choice([400, 800, 1600, 3200, 6400])), n_int=4, n_double=2),
        Op("aggregate", agg_fn="sum", group_by_dtype="int", agg_dtype="double",
           window=Window("sliding", "time", 30.0, 0.4), selectivity=0.12),
        Op("aggregate", agg_fn="mean", group_by_dtype="int", agg_dtype="double",
           window=Window("tumbling", "time", 8.0, 1.0), selectivity=0.2),
        Op("sink"),
    ]
    return with_widths(ops, [(0, 1), (1, 2), (2, 3)], "smart_grid_local")


DSPBENCH = {
    "advertisement": _advertisement,
    "spike_detection": _spike_detection,
    "smart_grid_global": _smart_grid_global,
    "smart_grid_local": _smart_grid_local,
}


def named_query(kind: str, shape: Draws, feat: Draws, name: str = "q") -> Query:
    """A synthetic query of ``kind`` (linear, two_way, three_way) or a DSPBench query by name."""
    if kind in DSPBENCH:
        return DSPBENCH[kind](feat)
    return synthetic_query(kind, shape, feat, name)


# --- hardware --------------------------------------------------------------------------------


def hardware_bin(h: Host) -> int:
    """Capability bin 0 (edge), 1 (workstation) or 2 (cloud) on log cpu + ram + bandwidth (Fig. 5 (2))."""
    lo = math.log(CPU[0]) + math.log(RAM_MB[0]) + math.log(BANDWIDTH_MBPS[0])
    hi = math.log(CPU[-1]) + math.log(RAM_MB[-1]) + math.log(BANDWIDTH_MBPS[-1])
    score = math.log(max(h.cpu, 1e-9)) + math.log(max(h.ram_mb, 1e-9)) + math.log(max(h.bandwidth_mbps, 1e-9))
    t = (score - lo) / max(hi - lo, 1e-9)
    return 0 if t < 1.0 / 3.0 else (1 if t < 2.0 / 3.0 else 2)


def _host(feat: Draws) -> Host:
    return Host(float(feat.choice(CPU)), float(feat.choice(RAM_MB)),
                float(feat.choice(BANDWIDTH_MBPS)), float(feat.choice(LATENCY_MS)))


def cluster(shape: Draws, feat: Draws, n_hosts: Optional[int] = None,
            fixed_bins: bool = False) -> Cluster:
    """``n_hosts`` hosts (drawn from 3..8 when None) with Table II values.

    With ``fixed_bins`` the ``shape`` generator first draws each host's capability bin from a host
    of its own, and ``feat`` then draws that host's values again until they fall in the same bin:
    the bins, which decide the valid placements, follow the shape; the values follow the seed.
    """
    n = shape.integers(N_HOSTS[0], N_HOSTS[1] + 1) if n_hosts is None else int(n_hosts)
    if not fixed_bins:
        return tuple(_host(feat) for _ in range(n))
    hosts = []
    for _ in range(n):
        want = hardware_bin(_host(shape))
        h = _host(feat)
        while hardware_bin(h) != want:
            h = _host(feat)
        hosts.append(h)
    return tuple(hosts)


def random_placement(q: Query, c: Cluster, feat: Draws) -> Tuple[int, ...]:
    """A random placement with a mild co-location bias (the corpus's own rule)."""
    n = len(c)
    assign = [0] * len(q.ops)
    for i, op in enumerate(q.ops):
        if op.kind == "source" or feat.random() < 0.35:
            assign[i] = feat.integers(0, n)
        else:
            parents = q.parents(i)
            if parents and feat.random() < 0.5:
                assign[i] = assign[parents[0]]
            else:
                assign[i] = feat.integers(0, n)
    return tuple(assign)


# --- placement candidates (paper Sec. V, Fig. 5) -------------------------------------------


def validity_mask(q: Query, c: Cluster, assignments: np.ndarray, paths=None) -> np.ndarray:
    """Rows that keep bins non-decreasing along the data flow and never revisit a host on a path."""
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    ok = np.ones(n, dtype=bool)
    if n == 0 or not q.edges:
        return ok
    bins = np.asarray([hardware_bin(h) for h in c])
    e_u = np.asarray([u for u, _ in q.edges])
    e_v = np.asarray([v for _, v in q.edges])
    ok &= (bins[assignments[:, e_u]] <= bins[assignments[:, e_v]]).all(axis=1)
    for path in paths if paths is not None else q.root_to_sink_paths():
        hosts = assignments[:, path]
        L = hosts.shape[1]
        if L < 3:
            continue
        changed = hosts[:, 1:] != hosts[:, :-1]
        pref = np.concatenate([np.zeros((n, 1), dtype=np.int64), np.cumsum(changed, axis=1)], axis=1)
        same = hosts[:, :, None] == hosts[:, None, :]
        moved = pref[:, None, :] > pref[:, :, None]
        upper = np.triu(np.ones((L, L), dtype=bool), k=2)
        ok &= ~(same & moved & upper).any(axis=(1, 2))
    return ok


def _dedup(a: np.ndarray) -> np.ndarray:
    if len(a) == 0:
        return a
    _, first = np.unique(a, axis=0, return_index=True)
    return a[np.sort(first)]


def _draw_assignments(q: Query, c: Cluster, n: int, rng: np.random.Generator, coloc: float = 0.4) -> np.ndarray:
    bins = np.asarray([hardware_bin(h) for h in c])
    order_desc = np.argsort(-bins, kind="stable")
    count_ge = np.asarray([(bins >= b).sum() for b in range(int(bins.max()) + 2)])
    assign = np.zeros((n, len(q.ops)), dtype=np.int64)
    for u in q.topological_order():
        parents = q.parents(u)
        min_bin = bins[assign[:, parents]].max(axis=1) if parents else np.zeros(n, dtype=np.int64)
        pick = order_desc[(rng.random(n) * count_ge[min_bin]).astype(np.int64)]
        if parents:
            via = np.asarray(parents)[rng.integers(0, len(parents), size=n)]
            pick = np.where(rng.random(n) < coloc, assign[np.arange(n), via], pick)
        assign[:, u] = pick
    return assign


def candidates(q: Query, c: Cluster, k: int, rng: np.random.Generator, tries_factor: int = 30) -> np.ndarray:
    """Up to ``k`` distinct valid placements, ``(<= k, n_ops)``, drawn in vectorized rounds."""
    budget = k * tries_factor
    paths = q.root_to_sink_paths()
    pool = np.zeros((0, len(q.ops)), dtype=np.int64)
    while len(pool) < k and budget > 0:
        draw = min(max(2 * (k - len(pool)), 32), budget)
        budget -= draw
        batch = _draw_assignments(q, c, draw, rng)
        pool = _dedup(np.concatenate([pool, batch[validity_mask(q, c, batch, paths)]], axis=0))
    return pool[:k]
