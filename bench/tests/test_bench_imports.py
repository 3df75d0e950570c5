"""No run loads JAX or the JAX package, and the reference loads nothing of the program: the whole
top-level names of ``sys.modules``, read in a fresh process."""

import json
import subprocess
import sys

from bench_small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from bench_small import run_small
out = run_small({cell!r}, trace=True)
assert out["correct"], out
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import bench.reference.featurize, bench.reference.gnn, bench.harness.workload, bench.harness.check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "bench" / "tests", capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    for cell in ("synthetic.estimate-many", "dspbench.score"):
        names = _top_level(RUN.format(root=str(ROOT), cell=cell))
        assert "repro_torch" in names  # the port ran
        assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE.format(root=str(ROOT)))
    assert "bench" in names
    assert not names & (FORBIDDEN | {"repro_torch"}), names & (FORBIDDEN | {"repro_torch"})


def test_the_command_checks_whole_top_level_names(monkeypatch):
    from bench.harness import spec

    command = spec.load_module(ROOT / "bench" / "run.py")
    assert not set(command.forbidden_modules()) & FORBIDDEN  # this process loaded none of them
    monkeypatch.setitem(sys.modules, "repro_torch_probe.sub", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert command.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert command.forbidden_modules() == ["jax", "repro"]
