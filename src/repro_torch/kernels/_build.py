"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface (``build/repro_torch/<name>-<digest>.so`` at
the repository root), for ``sm_90a``.  The digest covers the sources and the
flags, so an edited kernel rebuilds and a stale library is never loaded.
Builds happen at first use, never at import; ``build_all`` starts one
``nvcc`` per source at once.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("banked_mlp", "mp_update")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MAX_RANGES = 12  # kMaxRanges in csrc/mlp_tile.cuh


class SlotRanges(ctypes.Structure):
    """``repro_torch::SlotRanges``: (type, start, stop) triples, by value."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("type", ctypes.c_int * MAX_RANGES),
        ("start", ctypes.c_int * MAX_RANGES),
        ("stop", ctypes.c_int * MAX_RANGES),
    ]

    @classmethod
    def of(cls, ranges) -> "SlotRanges":
        ranges = tuple(ranges)
        if not 1 <= len(ranges) <= MAX_RANGES:
            raise ValueError(f"need 1..{MAX_RANGES} slot ranges, got {len(ranges)}")
        s = cls()
        s.n = len(ranges)
        for i, (t, a, b) in enumerate(ranges):
            s.type[i], s.start[i], s.stop[i] = int(t), int(a), int(b)
        return s


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    # x, x_member_stride, w1, b1, w2, b2, y, E, B, N, F, H1, H2, T, ranges, device, stream
    "banked_mlp": ("banked_mlp_launch", [_P, _L, _P, _P, _P, _P, _P] + [_I] * 7 + [SlotRanges, _I, _P]),
    # h, out, a_flow, a_bs, depth, d_bs, mask, m_bs, w1, b1, w2, b2, E, B, N, H, H1, T,
    # ranges, span_start, span_stop, parent_rows, d, device, stream
    "mp_update": (
        "mp_update_launch",
        [_P, _P, _P, _L, _P, _L, _P, _L, _P, _P, _P, _P] + [_I] * 6 + [SlotRanges] + [_I] * 5 + [_P],
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); cannot build the CUDA kernels")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and shared memory per compiled kernel from ``-Xptxas -v``."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"(\w+_kernel)ILi(\d+)E", m.group(1))  # demangle kernel<CPT>
            entry = out.setdefault(f"{t.group(1)}<{t.group(2)}>" if t else m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            entry["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def build_all(names: Sequence[str] = KERNELS, force: bool = False) -> Dict[str, Dict]:
    """Compile every missing library of ``names`` (every one with ``force``),
    one ``nvcc`` each, all started at once.

    Returns, for each library this call built, the seconds until it was
    done, the ``-Xptxas -v`` summary per kernel entry and its path.  Raises
    ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _library_path(n) for n in names if force or not _library_path(n).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed, built = [], {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)
        built[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": _ptxas_summary(log),
            "path": str(lib),
        }
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def launcher(name: str):
    """The ``ctypes`` entry point of kernel ``name``, building it on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _loaded:
            lib = _library_path(name)
            if not lib.exists():
                build_all([name])
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return _loaded[name]


def check(name: str, err: int) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
