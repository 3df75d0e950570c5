"""The readers of the program's spans (``harness/spans.py``): a finite value from a traced CPU run
of each family's cell, and None where there is no record or no ``repro_torch.obs``."""

import math
import sys
from collections import deque
from types import SimpleNamespace

import pytest

from bench_small import ROOT, run_small

PARTS = ("prep_ms", "stage_ms", "forward_ms", "wait_ms", "vote_ms", "stage3_pad")
FAMILIES = {"estimate": ("synthetic.estimate-many", "estimate_many"), "score": ("dspbench.score", "score_many")}
READERS = [(f"{part}.{family}", family) for family in FAMILIES for part in PARTS]


@pytest.fixture(scope="module")
def traced():
    """Each family's cell run once with its traced stretch, and the spans it left."""
    from repro_torch import obs

    out = {}
    for family, (cell, _) in FAMILIES.items():
        line = run_small(cell, trace=True)
        assert line["correct"] is True
        out[family] = (line, obs.records())
    return out


def _read(name, entry):
    from bench.harness import spec

    return spec.reader(name, ROOT)(SimpleNamespace(entry=entry))


@pytest.mark.parametrize("name,family", READERS)
def test_a_reader_gives_a_finite_value_from_a_traced_run(traced, name, family, monkeypatch):
    from repro_torch import obs

    line, records = traced[family]
    value = line["metrics"][name]["value"]
    assert math.isfinite(value) and value >= 0
    monkeypatch.setattr(obs, "_records", deque(records))  # the same stretch, read again here
    assert _read(name, FAMILIES[family][1]) == pytest.approx(value)
    other = "score_many" if family == "estimate" else "estimate"
    assert _read(name, other) is None  # the other family's cells


@pytest.mark.parametrize("name,family", READERS)
def test_a_reader_gives_none_without_a_record(name, family, monkeypatch):
    from repro_torch import obs

    entry = FAMILIES[family][1]
    monkeypatch.setattr(obs, "_records", deque())
    assert _read(name, entry) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # a program without the tracer
    assert _read(name, entry) is None
