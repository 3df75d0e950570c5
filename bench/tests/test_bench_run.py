"""A CPU dry run of each cell's whole run, ending in a result line of the contract's shape; the
command refusing a machine without a card; the result line's last key."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench_small import CELLS, ROOT, run_small

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _names(kind, cell):
    return {m["name"] for m in _spec()[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_ends_in_the_contracts_line(cell):
    out = run_small(cell)
    assert RESULT_KEYS <= set(out) and out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == _names("end_to_end", cell)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert list(out)[-1] == "check"  # the numbers compared come last
    assert set(out["check"]["answer_err"]) == {"value", "limit"}
    assert out["check"]["answer_err"]["value"] <= out["check"]["answer_err"]["limit"]
    assert out["check"]["calls"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(cell):
    out = run_small(cell, trace=True)
    assert out["correct"] is True
    names = _names("per_layer", cell)
    # on the CPU the profiler sees no device op: the kernels' rooflines stay silent
    assert {n for n in names if "roofline" not in n} <= set(out["metrics"]) <= names
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_the_command_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "dspbench.score", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_the_same_seed_gives_the_same_traffic():
    from bench.harness import spec, traffic as T

    for cell in ("synthetic.estimate", "synthetic.score"):
        c = spec.cell(cell)
        mix = dict(c.traffic, pool_graphs=64, batch_graphs=16, structures=6, pool_candidates=16)
        a, b = T.build(c.config, mix, 7), T.build(c.config, mix, 7)
        assert a.traces == b.traces and [s[:2] for s in a.structures] == [s[:2] for s in b.structures]
        for (_, _, p), (_, _, q) in zip(a.structures, b.structures):
            assert (p == q).all()


def test_a_scoring_mix_gives_every_seed_the_same_work():
    from bench.harness import spec, traffic as T

    c = spec.cell("synthetic.score")
    mix = dict(c.traffic, structures=12, pool_candidates=64)
    shapes = set()
    for seed in (1, 2, 2**33 + 5):
        t = T.build(c.config, mix, seed)
        shapes.add(tuple((len(q.ops), q.edges, len(cl)) for q, cl, _ in t.structures))
    assert len(shapes) == 1


def test_the_arrival_schedules_match_the_programs():
    from repro_torch.serve import load

    from bench.harness import arrivals

    for seed in (0, 7, 2**33):
        assert np.array_equal(arrivals.poisson_arrivals(120.0, 300, seed), load.poisson_arrivals(120.0, 300, seed))
        assert np.array_equal(arrivals.bursty_arrivals(120.0, 300, seed, 4.0, 0.25),
                              load.bursty_arrivals(120.0, 300, seed, 4.0, 0.25))


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(cuda):
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "dspbench.score", "--seed", "5",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert "banked_mlp_roofline.score" in out["metrics"]
