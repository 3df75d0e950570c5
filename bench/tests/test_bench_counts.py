"""The FLOP and byte counters against hand counts at small shapes."""

import numpy as np
import pytest

import bench_small  # noqa: F401

from bench.harness import spec
from bench.harness.facts import CallWork, Facts, of_graphs

H, E = 4, 2  # hidden width, members


def mlp(fi, h, fo):
    return 2 * fi * h + h + 2 * h * fo + fo


def _facts(n_ops, n_hw, depth_rows, depth_edges):
    rows = np.zeros((len(n_ops), 9), np.int64)
    edges = np.zeros((len(n_ops), 9), np.int64)
    for k, (r, e) in enumerate(zip(depth_rows, depth_edges)):
        rows[k, : len(r)] = r
        edges[k, : len(e)] = e
    return Facts(np.asarray(n_ops), np.asarray(n_hw), rows, edges)


# two graphs: a chain source -> filter -> sink on 2 hosts, and a 2-way join
# (2 sources, join, sink) on 3 hosts
CHAIN_JOIN = _facts([3, 4], [2, 3], [[1, 1, 1], [2, 1, 1]], [[0, 1, 1], [0, 2, 1]])


def test_model_flops_by_hand():
    work = CallWork("estimate", CHAIN_JOIN, CHAIN_JOIN, E, H)
    per_member = (
        7 * mlp(39, H, H) + 5 * mlp(4, H, H)  # stage 0: 7 operators, 5 hosts
        + 7 * H + 5 * mlp(2 * H, H, H)  # stage 1
        + 7 * mlp(2 * H, H, H)  # stage 2
        + 4 * mlp(2 * H, H, H) + 5 * H  # stage 3: 4 operators at depth >= 1, 5 edges into them
        + 12 * H + 2 * mlp(H, H, 1)  # readout
    )
    assert spec.count("model").flops(work) == E * per_member


def test_stage0_counts_once_per_structure_when_scoring():
    one = _facts([3], [2], [[1, 1, 1]], [[0, 1, 1]])
    three = one.take(np.array([0, 0, 0]))
    score = spec.count("model").flops(CallWork("score_many", three, one, E, H))
    each = spec.count("model").flops(CallWork("estimate", three, three, E, H))
    assert each - score == 2 * E * (3 * mlp(39, H, H) + 2 * mlp(4, H, H))


def test_mp_update_launches_by_hand():
    work = CallWork("estimate", CHAIN_JOIN, CHAIN_JOIN, E, H)
    launches = spec.count("mp_update").launches(work)
    assert len(launches) == 8  # the scan runs every depth up to MAX_DEPTH
    nbytes = 4 * (E * H * 2 * 7 + (9 + 16) + 2 * 7 + E * 5 * (2 * H * H + H + H * H + H))
    assert launches[0] == (E * (2 * mlp(2 * H, H, H) + 3 * H), nbytes)  # depth 1: 1 + 1 rows, 1 + 2 edges
    assert launches[1] == (E * (2 * mlp(2 * H, H, H) + 2 * H), nbytes)
    assert all(f == 0 and b == nbytes for f, b in launches[2:])
    assert spec.count("mp_update").launches(CallWork("estimate_many", CHAIN_JOIN, CHAIN_JOIN, E, H)) == []


def test_mp_sweep_launch_by_hand():
    (f, b), = spec.count("mp_sweep").launches(CallWork("estimate_many", CHAIN_JOIN, CHAIN_JOIN, E, H))
    assert f == E * (4 * mlp(2 * H, H, H) + 5 * H)
    assert b == 4 * (E * H * 2 * 7 + 25 + 14 + E * 5 * (2 * H * H + H + H * H + H))


def test_banked_mlp_launches_by_hand():
    bank = spec.count("banked_mlp")
    est = bank.launches(CallWork("estimate", CHAIN_JOIN, CHAIN_JOIN, E, H))
    assert len(est) == 4
    assert est[0] == (E * 7 * mlp(39, H, H), 4 * (E * 5 * (39 * H + H + H * H + H) + 7 * 39 + E * 7 * H))
    assert est[2] == (E * 5 * mlp(2 * H, H, H), 4 * (E * (2 * H * H + H + H * H + H) + E * 5 * 2 * H + E * 5 * H))
    score = bank.launches(CallWork("score_many", CHAIN_JOIN, CHAIN_JOIN, E, H))
    assert len(score) == 4 + 2  # two stage-3 levels present
    assert score[4][0] == E * 2 * mlp(2 * H, H, H)


def test_facts_of_featurized_graphs():
    from bench.harness import workload as W
    from bench.reference import featurize as R

    ops = [W.Op("source", n_int=3, event_rate=100.0), W.Op("source", n_int=2, event_rate=50.0),
           W.Op("join", join_key_dtype="int", window=W.Window("tumbling", "count", 10.0, 0.5), selectivity=0.1),
           W.Op("sink")]
    q = W.with_widths(ops, [(0, 2), (1, 2), (2, 3)], "j")
    host = W.Host(100.0, 1000.0, 100.0, 1.0)
    f = of_graphs(R.placed(q, (host, host, host), np.array([[0, 1, 2]])[:, [0, 1, 2, 2]]))
    assert f.n_ops.tolist() == [4] and f.n_hw.tolist() == [3]
    assert f.depth_rows[0, :3].tolist() == [2, 1, 1] and f.depth_edges[0, :3].tolist() == [0, 2, 1]


@pytest.mark.parametrize("kernel", ["mp_update", "mp_sweep", "banked_mlp"])
def test_a_roofline_is_silent_where_the_launches_are_not_the_counted_ones(kernel):
    from bench.harness import peaks
    from bench.harness.profile import Trace

    call = CallWork("estimate" if kernel != "mp_sweep" else "estimate_many", CHAIN_JOIN, CHAIN_JOIN, E, H)

    class Run:
        entry = call.entry
        trace = Trace(1.0, 0.5, {f"void repro_torch::{kernel}_kernel<64>(args)": (1, 1e-3)}, calls=[0])

        def work(self, i):
            return call

    expected = len(spec.count(kernel).launches(call))
    value = peaks.roofline(Run(), kernel)
    assert (value is None) == (expected != 1)
