"""CUDA graphs of ``score_many``'s merged forward.

On a GPU, ``CostEstimator.score_many`` launches each chunk's merged forward
(``core.gnn.apply_gnn_merged_rows``) by replaying a CUDA graph: one
``MergedGraph`` per (merged-group entry, stacked ensemble, row bucket), kept
on its merged-group entry and dropped with it.  The forward is the same
function, eager or captured; the graph only replaces its tens of eager
launches a chunk by one replay.

* **Row buckets.**  A chunk of ``n`` rows runs at ``row_bucket(n)`` rows, a
  multiple of ``ROW_BUCKET``.  The pad rows are skeleton 0 placed nowhere
  (``a_place`` all zeros): finite, and no reduction crosses rows, so they
  change no real row; their outputs are never read back.
* **Static inputs.**  ``skel_id`` and ``a_place`` live in one device buffer in
  ``nn.pack_host``'s layout (``nn.device_buffer``); ``stage`` writes a chunk
  and its zero pad into a page-locked buffer and copies it there with one
  ``non_blocking`` copy (``nn.parts_to_device(..., into=)``).
* **Capture on first sight.**  The first call of a (group, ensemble, bucket)
  runs the forward eagerly on the static inputs (its answer, and the warm-up
  that loads every kernel before capture), then captures it into the
  estimator's one memory pool (``torch.cuda.graph_pool_handle``).  Later
  calls replay it.
* **Stream order.**  Staging, replay and the readback queued right behind it
  (``estimator._queue_host``) share the one stream, so call i's readback runs
  before call i + 1's inputs land and before replay i + 1 overwrites the
  output.  Graphs of one pool may share scratch memory, which is safe
  because replays never overlap and each output is read back before the next
  replay of any graph.
* **Counters.**  ``cache.graph.miss`` counts a first sight (the estimator),
  ``cache.graph.hit`` a replay, ``cache.graph.failed`` a capture that
  failed.  The launches of a capture go to its thread's tally
  (``obs.capture_tally``), not to the ``<kernel>.launches`` counters, and
  each replay adds them there, so the counters still count the kernels that
  ran.  A capture synchronizes the device and collects garbage first
  (``torch.cuda.graph``'s own preparation), once per graph.

The eager path stays for the CPU and for a (group, ensemble, bucket) whose
capture failed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import nn, obs
from repro_torch.core.gnn import MergedConstants, apply_gnn_merged_rows
from repro_torch.serve.stacking import StackedEnsembles

ROW_BUCKET = 256  # a chunk's rows round up to a multiple of this


def row_bucket(n: int) -> int:
    """The rows a merged chunk of ``n`` rows runs at: ``n`` rounded up to a multiple of ``ROW_BUCKET``."""
    return max(1, -(-int(n) // ROW_BUCKET)) * ROW_BUCKET


def padded_parts(skel_id: np.ndarray, a_place: np.ndarray, rows: int):
    """A chunk's ``skel_id`` and ``a_place`` as ``nn.parts_to_device`` parts,
    each padded to ``rows`` with zeros: skeleton 0, placed nowhere."""
    pad = rows - len(skel_id)
    return [
        [skel_id, np.zeros((pad,), skel_id.dtype)],
        [a_place, np.zeros((pad,) + a_place.shape[1:], a_place.dtype)],
    ]


class MergedGraph:
    """The merged forward of one (stack constants, stacked ensemble, row
    bucket), its static inputs and, once captured, its CUDA graph and output."""

    __slots__ = ("stacked", "consts", "rows", "buf", "skel_id", "a_place", "graph", "out", "launches", "failed")

    def __init__(self, stacked: StackedEnsembles, consts: MergedConstants, rows: int,
                 place_shape: Tuple[int, ...], device):
        self.stacked, self.consts, self.rows = stacked, consts, rows
        self.buf, (self.skel_id, self.a_place) = nn.device_buffer(
            [(np.int64, (rows,)), (np.float32, (rows, *place_shape))], device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.failed = False

    def stage(self, skel_id: np.ndarray, a_place: np.ndarray) -> None:
        """Queue a chunk's rows, padded to the bucket, into the static inputs (one copy)."""
        nn.parts_to_device(padded_parts(skel_id, a_place, self.rows), self.buf.device, into=self.buf)

    def forward(self) -> torch.Tensor:
        """The eager forward over the static inputs -> ``(E, rows)``."""
        return apply_gnn_merged_rows(self.stacked.params, self.consts, self.skel_id, self.a_place,
                                     self.stacked.cfgs[0].gnn)

    def run(self, pool) -> Tuple[torch.Tensor, str]:
        """The forward over the staged rows, with no autograd, and how it ran:
        ``"hit"`` (a replay), ``"capture"`` (eager, then captured for later
        calls) or ``"eager"`` (the capture failed)."""
        if self.failed:
            return self.forward(), "eager"
        if self.graph is not None:
            obs.count("cache.graph.hit")
            self.graph.replay()
            for k, v in self.launches.items():
                obs.count(k, v)
            return self.out, "hit"
        out = self.forward()
        self._capture(pool)
        return out, "capture" if self.graph is not None else "eager"

    def _capture(self, pool) -> None:
        """Capture the forward; each kernel launched in it is kept in
        ``launches`` (``obs.capture_tally``), for every replay to count.  A
        capture that fails (``cache.graph.failed``) leaves this graph eager
        for good; running out of device memory is raised."""
        graph = torch.cuda.CUDAGraph()
        try:
            with obs.capture_tally() as tally, torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                out = self.forward()
        except torch.OutOfMemoryError:
            raise
        except RuntimeError:
            self.failed = True
            obs.count("cache.graph.failed")
        else:
            self.graph, self.out, self.launches = graph, out, tally
