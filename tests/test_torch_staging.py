"""``estimate_many``'s host preparation on the CPU: the banding cache's key and the one-copy staging.

``bucketing.banding_key`` packs each row's signature into one int64 and keys on the sorted unique
codes: two batches share a key, and so one banding cache entry, exactly when their
``batch_signature`` sets are equal, over seeded random batches with padded rows, depth 0 and
``MAX_DEPTH``, single graphs and batches of 1 and 4,096; past 15 slots or depth 14 the key is the
signature tuples.  ``nn.pack_host_parts`` and ``stage_graph_batches`` hold, bitwise,
``np.concatenate``'s and ``merge_graph_batches``'s values in ``pack_host``'s layout, and
``estimate_many`` over staged batches (the GPU path's data flow, here with CPU tensors) answers
as ``merge_graph_batches`` plus ``exact_banding`` do.
"""

import numpy as np
import pytest
import torch

from repro_torch import nn
from repro_torch.core import bucketing, gnn
from repro_torch.core.graph import (
    MAX_DEPTH,
    MAX_OPS,
    SLOT_RANGES,
    JointGraph,
    batch_graphs,
    build_graph,
    merge_graph_batches,
)
from repro_torch.core.model import CostModelConfig, forward_ensemble, init_cost_model
from repro_torch.dsps import WorkloadGenerator
from repro_torch.serve.estimator import CostEstimator, _graph_forward, graphs_to_device, stage_graph_batches
from repro_torch.serve.stacking import _split_votes


def _graphs(depth, mask):
    """A batched ``JointGraph`` with these depths and masks (a single graph for 1-D arrays);
    slot types follow ``SLOT_RANGES`` where the rows are ``MAX_OPS`` wide."""
    depth, mask = np.asarray(depth), np.asarray(mask, dtype=np.float32)
    n = depth.shape[-1]
    types = np.zeros(n, np.int32)
    for t, start, stop in SLOT_RANGES:
        types[start:min(stop, n)] = t
    lead = depth.shape[:-1]
    return JointGraph(
        op_x=np.zeros(lead + (n, 2), np.float32),
        op_type=np.broadcast_to(types, lead + (n,)).copy(),
        op_mask=mask,
        op_depth=depth,
        hw_x=np.zeros(lead + (2, 1), np.float32),
        hw_mask=np.ones(lead + (2,), np.float32),
        a_flow=np.zeros(lead + (n, n), np.float32),
        a_place=np.zeros(lead + (n, 2), np.float32),
    )


def _random_batches(rng, n_batches=60):
    """Batches drawn from a small pool of row signatures (so signature sets repeat in other
    orders and multiplicities), with all-padded rows, depth 0 and ``MAX_DEPTH``, and masked
    slots whose depth field is not 0."""
    pool_depth = rng.integers(0, MAX_DEPTH + 1, size=(12, MAX_OPS)).astype(np.int32)
    pool_mask = rng.random((12, MAX_OPS)) < 0.6
    pool_mask[0] = False  # an all-padded row
    pool_depth[1], pool_mask[1] = 0, True  # every slot at depth 0
    pool_depth[2], pool_mask[2] = MAX_DEPTH, True
    pool_depth[3] = np.where(pool_mask[3], pool_depth[3], 5)  # padded slots that carry a depth
    batches = []
    for i in range(n_batches):
        size = (1, 2, 3, 7, 64)[i % 5]
        rows = rng.choice(rng.permutation(12)[: rng.integers(1, 5)], size=size)
        batches.append(_graphs(pool_depth[rows], pool_mask[rows]))
    batches.append(_graphs(pool_depth[5], pool_mask[5]))  # a single graph
    for r in range(12):  # every pool row alone: the all-padded row against the all-depth-0 one
        batches.append(_graphs(pool_depth[r : r + 1], pool_mask[r : r + 1]))
    one = pool_mask[1].copy()
    one[7] = False  # the all-depth-0 row with one slot padded
    batches.append(_graphs(pool_depth[1:2], one[None]))
    rows = rng.integers(0, 12, size=4096)
    batches.append(_graphs(pool_depth[rows], pool_mask[rows]))
    batches.append(_graphs(pool_depth[np.sort(rows)[::-1]], pool_mask[np.sort(rows)[::-1]]))
    return batches


def test_banding_key_is_exact_on_signature_sets():
    """Equal keys exactly where the signature sets are equal; one cache entry per distinct set,
    each the plan ``exact_banding`` computes, and the same object on every later hit."""
    batches = _random_batches(np.random.default_rng(28))
    sets = [frozenset(bucketing.batch_signature(g)) for g in batches]
    keys = [bucketing.banding_key(g) for g in batches]
    assert all(isinstance(k[1], bytes) for k in keys)  # all packed: 12 slots, depth at most 8
    for i in range(len(batches)):
        for j in range(len(batches)):
            assert (keys[i] == keys[j]) == (sets[i] == sets[j]), (i, j)
    assert len(set(sets)) < len(sets)  # some sets do repeat
    bucketing._BANDING_CACHE.clear()
    first = {}
    for g, sig in zip(batches, sets):
        banding, hit = bucketing.exact_banding_lookup(g)
        assert hit == (sig in first)
        assert banding == bucketing.exact_banding(g)
        if hit:
            assert banding is first[sig]
        first.setdefault(sig, banding)
    assert len(bucketing._BANDING_CACHE) == len(first)


def test_banding_key_widths_never_share():
    """The same codes over rows of other widths are other keys: trailing padded slots."""
    a = _graphs(np.array([[0, 1, 2]], np.int32), np.ones((1, 3)))
    b = _graphs(np.array([[0, 1, 2, 0]], np.int32), np.array([[1, 1, 1, 0]]))
    assert bucketing.banding_key(a) != bucketing.banding_key(b)


@pytest.mark.parametrize("case", ["16_slots", "depth_15", "depth_minus_2", "float_depth"])
def test_banding_key_falls_back_to_signature_tuples(case):
    """Rows past 15 slots, a depth above 14 or below -1, or depths that are not signed integers:
    the key is ``batch_signature``'s tuples, and the cache still hits on an equal set."""
    rng = np.random.default_rng(3)
    depth = rng.integers(0, 5, size=(6, 16 if case == "16_slots" else MAX_OPS)).astype(np.int32)
    mask = np.ones(depth.shape)
    if case == "depth_15":
        depth[2, 4] = 15
    elif case == "depth_minus_2":
        depth[1, 0] = -2
    elif case == "float_depth":
        depth = depth.astype(np.float32)
    g = _graphs(depth, mask)
    assert bucketing.banding_key(g) == bucketing.batch_signature(g)
    bucketing._BANDING_CACHE.clear()
    plan, hit = bucketing._banding_lookup(g, "conservative", bucketing.batch_banding)
    again, hit_again = bucketing._banding_lookup(
        _graphs(depth[::-1].copy(), mask), "conservative", bucketing.batch_banding)
    assert (hit, hit_again) == (False, True) and again is plan
    assert plan == bucketing.batch_banding(g)


def test_depth_fourteen_still_packs():
    """Depth 14 is the deepest that packs (``depth + 1`` = 15 fills 4 bits)."""
    depth = np.zeros((2, MAX_OPS), np.int32)
    depth[0, 3] = 14
    g = _graphs(depth, np.ones(depth.shape))
    assert isinstance(bucketing.banding_key(g)[1], bytes)


def test_pack_host_parts_equals_concatenate():
    """Mixed dtypes, broadcast views and an empty part: ``np.concatenate``'s values, bitwise, in
    ``pack_host``'s layout of the joined arrays."""
    rng = np.random.default_rng(5)
    parts = [
        [rng.random((3, 4), dtype=np.float32), np.broadcast_to(np.float32(2.5), (0, 4)),
         np.broadcast_to(rng.random(4, dtype=np.float32), (5, 4))],
        [np.arange(3, dtype=np.int32), np.arange(2, dtype=np.int32), np.arange(1, dtype=np.int32)],
        [rng.integers(0, 2, (2, 3, 3)).astype(np.uint8), np.ones((1, 3, 3), np.uint8), np.zeros((0, 3, 3), np.uint8)],
    ]
    buf, layout = nn.pack_host_parts(parts, pin=False)
    joined = [np.concatenate(ps) for ps in parts]
    want_buf, want_layout = nn.pack_host(joined, pin=False)
    assert layout == want_layout
    for o, n, _, _ in layout:  # each field's bytes (the alignment padding is left unwritten)
        assert torch.equal(buf[o : o + n], want_buf[o : o + n])
    for got, want in zip(nn.unpack(buf, layout), joined):
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)


def _corpus_batches(seed=28, sizes=(40, 1, 0, 23, 64)):
    traces = WorkloadGenerator(seed=seed).corpus(sum(sizes))
    graphs = [build_graph(t.query, t.cluster, t.placement) for t in traces]
    out, off = [], 0
    for n in sizes:
        if n:
            out.append(batch_graphs(graphs[off : off + n]))
        else:  # an empty batch
            out.append(JointGraph(*[np.asarray(x)[:0] for x in batch_graphs(graphs[:1])]))
        off += n
    return out


def test_stage_graph_batches_matches_merge():
    """The staged host graphs and their tensors equal ``merge_graph_batches``'s arrays, bitwise."""
    batches = _corpus_batches()
    host, dev = stage_graph_batches(batches, "cpu")
    merged = merge_graph_batches(batches).graphs
    for h, d, m in zip(host, dev, merged):
        assert h.dtype == m.dtype and h.shape == m.shape and np.array_equal(h, m)
        assert np.array_equal(d.numpy(), m)


@pytest.fixture(scope="module")
def estimator():
    cfg = gnn.GNNConfig(hidden=16, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    models = {m: (init_cost_model(gen, CostModelConfig(metric=m, gnn=cfg, n_ensemble=2)),
                  CostModelConfig(metric=m, gnn=cfg, n_ensemble=2))
              for m in ("latency_p", "throughput", "success")}
    return CostEstimator(models, device="cpu")


@pytest.mark.parametrize("max_rows", [None, 32])
def test_estimate_many_staged_matches_merge_and_exact_banding(estimator, max_rows):
    """``estimate_many``'s answers, and those of its merged forward over staged batches (the
    GPU path's data flow), equal, bitwise, one forward per chunk of ``merge_graph_batches``'s
    batch under ``exact_banding``'s plan; the cached plans are ``exact_banding``'s."""
    est = estimator
    metrics = tuple(est.models)
    batches = _corpus_batches()
    sizes = [len(b.op_x) for b in batches]
    merged = merge_graph_batches(batches).graphs
    (stacked,) = stacks = est._stacks_for(metrics)
    total = sum(sizes)
    step = max_rows or total
    parts = []
    for s in range(0, total, step):
        chunk = JointGraph(*[x[s : s + step] for x in merged])
        banding = bucketing.exact_banding(chunk)
        assert bucketing.exact_banding_cached(chunk) == banding
        with torch.no_grad():
            raw = forward_ensemble(stacked.params, graphs_to_device(chunk, "cpu"), stacked.cfgs[0], banding)
        parts.append(_split_votes(raw.numpy(), stacked))
    flat = {m: np.concatenate([p[m] for p in parts]) for m in metrics}
    want = np.split(np.arange(total), np.cumsum(sizes)[:-1])
    host, dev = stage_graph_batches(batches, "cpu")
    launched = est._launch(stacks, total, max_rows, est._graph_chunks(host, dev, True), _graph_forward)
    runs = (est.estimate_many(batches, max_rows=max_rows), est._collect(stacks, launched, sizes))
    for got in runs:
        assert len(got) == len(batches)
        for g_, idx in zip(got, want):
            for m in metrics:
                assert np.array_equal(g_[m], flat[m][idx]), m
