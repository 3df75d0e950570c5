"""A later change adds a configuration, a traffic mix and a per-layer metric as new files plus
``BENCHMARK.json`` entries, and the harness runs the new cell with no other file edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from bench_small import ROOT

NEW_READER = '''"""``graphs_per_call``: the mean number of graphs a call answered."""


def read(run):
    return sum(c.items for c in run.calls) / len(run.calls)
'''

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from bench.harness import session
out = session.run("tiny.estimate", 99, 0.3, {trace}, "cpu", time.perf_counter(), {root!r})
print(json.dumps(out))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = _digests(tmp_path)

    config = json.loads((tmp_path / "bench/configs/costream-synthetic.json").read_text())
    config.update(name="costream-tiny", population={"queries": ["linear"], "hosts": [3, 4]})
    (tmp_path / "bench/configs/costream-tiny.json").write_text(json.dumps(config))
    (tmp_path / "bench/traffic/tiny-estimate.json").write_text(json.dumps(
        {"entry": "estimate", "pool_graphs": 32, "batch_graphs": 16, "batches_per_call": 1, "in_flight": 2,
         "check_share": 0.5}))
    (tmp_path / "bench/metrics/graphs_per_call.py").write_text(NEW_READER)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "costream-tiny", "source": "https://arxiv.org/abs/2403.08444",
                            "file": "bench/configs/costream-tiny.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.estimate", "config": "costream-tiny", "traffic": "tiny-estimate",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "estimate_graphs_per_s":
            m["workloads"].append("tiny.estimate")
    spec["per_layer"].append({"name": "graphs_per_call", "unit": "graphs", "better": "higher",
                              "source": "host_clock", "layer": "serve.estimator",
                              "moves": "estimate_graphs_per_s", "workloads": ["tiny.estimate"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    outs = []
    for trace in (False, True):
        p = subprocess.run([sys.executable, "-c", RUN.format(root=str(tmp_path), trace=trace)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert outs[0]["correct"] and set(outs[0]["metrics"]) == {"estimate_graphs_per_s", "setup_s"}
    assert outs[1]["correct"] and outs[1]["metrics"]["graphs_per_call"]["value"] == 16.0
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before  # no file of the benchmark edited
