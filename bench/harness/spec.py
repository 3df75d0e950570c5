"""``BENCHMARK.json`` and the files it names: a cell's configuration, traffic mix and metrics.

Everything that belongs to one configuration, traffic mix or per-layer metric sits in a file of
its own, found by name: ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
``bench/metrics/<metric>.py`` (a ``read(run)`` function) and ``bench/counts/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration and traffic files read, and its metrics."""
    root = Path(root)
    spec = load_benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in spec['workloads']]}")
    w = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_module(path: Path):
    """A Python file as a module, by path (metric and count names carry dots)."""
    path = Path(path)
    mod_spec = importlib.util.spec_from_file_location(f"bench_file_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


_cache: Dict[Path, object] = {}


def reader(metric: str, root: Path = ROOT):
    """``bench/metrics/<metric>.py``'s ``read`` function."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    if path not in _cache:
        _cache[path] = load_module(path)
    return _cache[path].read


def count(name: str, root: Path = ROOT):
    """The module ``bench/counts/<name>.py``."""
    path = Path(root) / "bench" / "counts" / f"{name}.py"
    if path not in _cache:
        _cache[path] = load_module(path)
    return _cache[path]
