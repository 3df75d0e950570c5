"""The one traffic generator: a configuration's query population and a mix's parameters, from a seed.

A traffic mix (``bench/traffic/<name>.json``) names an ``entry`` of the program and its sizes:

* ``estimate`` / ``estimate_many``: a pool of ``pool_graphs`` placed queries drawn from the
  population, cut into batches of ``batch_graphs``; call ``i`` asks for the next
  ``batches_per_call`` batches, in turn;
* ``score_many``: ``structures`` (query, cluster) pairs, each with a pool of up to
  ``pool_candidates`` distinct valid placements, split in order into groups of ``group_size``;
  call ``i`` takes group ``i mod groups`` and, of each of its structures, the next
  ``rows_per_structure`` rows of the pool (the whole pool where it is smaller), in turn.
  Query shapes and the clusters' capability bins come from the mix's fixed ``shape_seed`` and every
  number inside them from the run's seed, so every seed asks for the same work.

Every mix keeps ``in_flight`` calls queued and compares a ``check_share`` of its calls, drawn from
the seed, with the plain reference.  An item is one answered graph or candidate; each has a global
id into the pool, which the reference answers once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from bench.harness import workload as W


@dataclass
class Traffic:
    entry: str
    in_flight: int
    check_share: float
    traces: List[W.Trace] = field(default_factory=list)  # estimate entries: the pool
    batches: List[np.ndarray] = field(default_factory=list)  # index arrays into ``traces``
    batches_per_call: int = 1
    structures: List[Tuple[W.Query, W.Cluster, np.ndarray]] = field(default_factory=list)
    groups: List[List[int]] = field(default_factory=list)
    rows: int = 0
    offsets: Optional[np.ndarray] = None  # first global id of each structure's pool

    @property
    def n_items(self) -> int:
        if self.entry == "score_many":
            return int(self.offsets[-1])
        return len(self.traces)

    def batch_ids(self, i: int) -> List[int]:
        n = len(self.batches)
        return [(i * self.batches_per_call + k) % n for k in range(self.batches_per_call)]

    def requests(self, i: int) -> List[Tuple[int, np.ndarray]]:
        """Call ``i`` of a scoring mix: ``[(structure, pool rows)]``, one per structure of its group."""
        g, r = i % len(self.groups), i // len(self.groups)
        out = []
        for s in self.groups[g]:
            n = len(self.structures[s][2])
            chunks = -(-n // self.rows)
            c = r % chunks
            out.append((s, np.arange(c * self.rows, min((c + 1) * self.rows, n))))
        return out

    def item_ids(self, i: int) -> np.ndarray:
        """Global ids of call ``i``'s items, in the order its answers come back."""
        if self.entry == "score_many":
            return np.concatenate([self.offsets[s] + rows for s, rows in self.requests(i)])
        return np.concatenate([self.batches[b] for b in self.batch_ids(i)])

    def cycle(self) -> int:
        """Calls after which the schedule repeats: set-up warms each of them once."""
        if self.entry == "score_many":
            chunks = [-(-len(p) // self.rows) for _, _, p in self.structures]
            return len(self.groups) * math.lcm(*chunks)
        n = len(self.batches)
        return n // math.gcd(n, self.batches_per_call)


def _kinds(population: dict) -> Tuple[List[str], List[float]]:
    kinds = list(population["queries"])
    return kinds, list(population.get("query_mix", [1.0] * len(kinds)))


def build(config: dict, mix: dict, seed: int) -> Traffic:
    """The cell's traffic for ``seed``."""
    population = config["population"]
    kinds, p = _kinds(population)
    entry = mix["entry"]
    t = Traffic(entry=entry, in_flight=int(mix["in_flight"]), check_share=float(mix["check_share"]))
    rng = W.Draws([int(seed), 0])
    if entry in ("estimate", "estimate_many"):
        n, b = int(mix["pool_graphs"]), int(mix["batch_graphs"])
        if n % b:
            raise ValueError(f"pool_graphs {n} is no multiple of batch_graphs {b}")
        lo, hi = population["hosts"]
        for k in range(n):
            q = W.named_query(rng.choice(kinds, p), rng, rng, name=f"q{k}")
            c = W.cluster(rng, rng, rng.integers(lo, hi + 1))
            t.traces.append(W.Trace(q, c, W.random_placement(q, c, rng)))
        t.batches = [np.arange(s, s + b) for s in range(0, n, b)]
        t.batches_per_call = int(mix["batches_per_call"])
        return t
    if entry != "score_many":
        raise ValueError(f"unknown entry {entry!r}")
    shape = W.Draws(int(mix["shape_seed"]))
    lo, hi = population["hosts"]
    for s in range(int(mix["structures"])):
        q = W.named_query(kinds[s % len(kinds)], shape, rng, name=f"s{s}")
        c = W.cluster(shape, rng, shape.integers(lo, hi + 1), fixed_bins=True)
        pool = W.candidates(q, c, int(mix["pool_candidates"]), np.random.default_rng([int(seed), 2, s]))
        t.structures.append((q, c, pool))
    size = int(mix["group_size"])
    t.groups = [list(range(a, min(a + size, len(t.structures)))) for a in range(0, len(t.structures), size)]
    t.rows = int(mix["rows_per_structure"])
    t.offsets = np.concatenate([[0], np.cumsum([len(pool) for _, _, pool in t.structures])]).astype(np.int64)
    return t


def check_calls(seed: int, share: float):
    """A generator of keep / skip decisions, one per call in order, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield bool(rng.random() < share)
