"""Each cell's traffic and the plain reference against the port's CPU path, at a small size: the
reference's featurization equals the program's, and its answers hold the check's limits."""

import numpy as np
import pytest

from bench_small import CELLS, SEED, SMALL


def _traffic(cell, seed=SEED):
    from bench.harness import spec, traffic as T

    c = spec.cell(cell)
    return c, T.build(c.config, dict(c.traffic, **SMALL[cell]), seed)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_featurizes_as_the_program_does(cell):
    from repro_torch.core.graph import build_graph, build_graph_skeleton, build_a_place_batch
    from repro_torch.dsps.placement import Placement

    from bench.harness.program import to_cluster, to_query
    from bench.reference import featurize as R

    _, t = _traffic(cell)
    if t.entry == "score_many":
        for q, c, pool in t.structures:
            want = build_graph_skeleton(to_query(q), to_cluster(c))
            got = R.skeleton(q, c)
            for f in ("op_x", "op_type", "op_mask", "op_depth", "hw_x", "hw_mask", "a_flow"):
                assert np.array_equal(getattr(got, f)[0], getattr(want, f)), f
            assert np.array_equal(R.placements(q, pool), build_a_place_batch(to_query(q), to_cluster(c), pool))
        return
    got = R.traces(t.traces)
    for k, tr in enumerate(t.traces):
        want = build_graph(to_query(tr.query), to_cluster(tr.cluster), Placement.of(tr.assignment))
        for f, x in zip(R.Graphs._fields, got):
            assert np.array_equal(x[k], getattr(want, f)), (k, f)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_answers_as_the_programs_cpu_path(cell):
    import torch

    from bench.harness import weights as Wt
    from bench.harness.check import Comparison
    from bench.harness.program import Program
    from bench.reference import featurize as R
    from bench.reference import gnn as G

    c, t = _traffic(cell)
    model = c.config["model"]
    w = Wt.make(SEED, model["metrics"], model["members"], model["hidden"], "cpu")
    program = Program(t, w, model, torch.device("cpu"))
    items = (R.concat([R.placed(q, cl, p) for q, cl, p in t.structures]) if t.entry == "score_many"
             else R.traces(t.traces))
    raw = G.raw_outputs(G.stack(w, model["metrics"]), items)
    cmp = Comparison(model["metrics"], model["members"])
    for i in range(t.cycle()):
        cmp.add(program.finish(program.dispatch(i)), raw[:, t.item_ids(i)])
    assert cmp.correct(), cmp.numbers()
    assert cmp.answers == sum(len(t.item_ids(i)) for i in range(t.cycle())) * len(model["metrics"])

