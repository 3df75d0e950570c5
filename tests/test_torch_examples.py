"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/*.py``, on the CPU (``--device cpu``, the plain PyTorch path).

``controller_demo`` scores with the noise-free simulator, so no model differs
between the packages: its output must equal the JAX script's line for line,
its one timing (the re-plan p95) dropped.  ``quickstart`` and
``optimize_placement`` train models whose weights are drawn by torch, not by
JAX, so only what is drawn from the pinned generator is compared: the corpus
and the heuristic placements and their simulated latencies.  ``serve_lm`` runs
its reduced default; ``train_lm``'s injected failure (exit 17) and restart must
end bitwise equal to an uninterrupted run.  The file takes about 15 s on one
core; it sets torch to one intra-op thread, since the suite's workers share
the cores.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dsps import WorkloadGenerator as JaxGenerator
from repro.dsps.simulator import SimulatorConfig as JaxSimulatorConfig, simulate as jax_simulate
from repro.placement import heuristic_placement as jax_heuristic
from repro_torch.examples import controller_demo, optimize_placement, quickstart, serve_lm, train_lm

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _untimed(text):
    return re.sub(r"replan p95 [0-9.]+ ms", "replan p95 <t> ms", text).splitlines()


def test_controller_demo_prints_what_the_jax_example_prints(capsys):
    _jax_example("controller_demo").main(["--smoke"])
    want = capsys.readouterr().out
    got = controller_demo.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _untimed(out) == _untimed(want)
    assert len(_untimed(out)) > 20
    assert got["ratio"] > 1.0 and len(got["ticks"]) == 12


def test_quickstart_smoke_runs_on_the_jax_example_corpus(capsys):
    got = quickstart.main(["--smoke", "--device", "cpu"])
    traces = JaxGenerator(seed=0).corpus(160)
    assert got["backpressured"] == sum(t.labels.backpressure == 0 for t in traces)
    assert got["failed"] == sum(t.labels.success == 0 for t in traces)
    assert got["bundle_metrics"] == ["latency_p"] and np.isfinite(got["best_val"])
    assert all(np.isfinite(q["predicted_ms"]) and q["predicted_ms"] >= 0 for q in got["queries"])
    assert got["stream"]["queries"] == 8 and got["stream"]["forwards"] >= 1
    assert f"corpus: 160 traces, {got['backpressured']} backpressured" in capsys.readouterr().out


def test_optimize_placement_smoke_runs_against_the_jax_heuristic():
    got = optimize_placement.main(["--smoke", "--device", "cpu"])
    gen = JaxGenerator(seed=1)
    gen.corpus(300)
    sim = JaxSimulatorConfig(noise_sigma=0.0)
    assert len(got["queries"]) == 2
    for i, rec in enumerate(got["queries"]):
        q, cluster = gen.query(name=f"demo{i}"), gen.cluster(6)
        base = jax_heuristic(q, cluster)
        assert rec["n_ops"] == q.n_ops()
        assert rec["heuristic"] == list(base.assignment)
        assert rec["heuristic_ms"] == jax_simulate(q, cluster, base, sim).latency_p
        assert np.isfinite(rec["costream_ms"]) and rec["feasible"] >= 1
    assert np.isfinite(got["median_speedup"])


def test_serve_lm_runs_its_reduced_default(capsys):
    got = serve_lm.main(["--device", "cpu"])
    assert got["arch"] == "recurrentgemma-2b" and got["logits_finite"]
    seqs = np.asarray(got["sequences"])
    assert seqs.shape == (4, 13) and (seqs[:, 0] == 1).all()
    assert "decoded 12 tokens x 4 requests" in capsys.readouterr().out


def test_train_lm_restart_after_injected_failure_is_bitwise(tmp_path):
    flags = ["--device", "cpu", "--steps", "8", "--ckpt-every", "3"]
    whole = train_lm.main(flags + ["--ckpt-dir", str(tmp_path / "whole")])
    with pytest.raises(SystemExit) as crash:
        train_lm.main(flags + ["--inject-failure", "5", "--ckpt-dir", str(tmp_path / "crash")])
    assert crash.value.code == 17
    resumed = train_lm.main(flags + ["--ckpt-dir", str(tmp_path / "crash")])
    assert resumed["resumed_from"] == 3 and sorted(resumed["losses"]) == [4, 5, 6, 7]
    assert sorted(whole["losses"]) == list(range(8))
    for step, loss in resumed["losses"].items():
        assert loss == whole["losses"][step] and resumed["grad_norms"][step] == whole["grad_norms"][step]
    final = [np.load(tmp_path / d / "step_0000000008" / "arrays.npz") for d in ("whole", "crash")]
    assert sorted(final[0].files) == sorted(final[1].files)
    for key in final[0].files:
        np.testing.assert_array_equal(final[0][key], final[1][key], err_msg=key)
