"""CUDA graphs of ``estimate``'s full-depth scan and ``score_many``'s merged forward.

On a GPU, ``CostEstimator`` launches two forwards by replaying a CUDA graph,
one ``ForwardGraph`` per (forward, stacked ensemble, row bucket):

* ``estimate`` of a batch: ``forward_ensemble``'s full-depth scan over the
  batch's ``JointGraph``, one graph per (stacked ensemble, row bucket,
  layout of the graph's fields), in the estimator's LRU of
  ``estimator.ESTIMATE_GRAPHS``;
* ``score_many``: each chunk's merged forward
  (``core.gnn.apply_gnn_merged_rows``, ``merged_graph``), one graph per
  (merged-group entry, stacked ensemble, row bucket), kept on its
  merged-group entry and dropped with it.

The forward is the same function, eager or captured; the graph only
replaces its tens of eager launches a call by one replay.

* **Row buckets.**  A batch or chunk of ``n`` rows (graphs, or candidate
  rows) runs at ``row_bucket(n)`` rows, a multiple of ``ROW_BUCKET``.  The
  pad rows are zeros (``zero_padded``): in ``estimate`` graphs with no
  operator, host, edge or placement, in ``score_many`` skeleton 0 placed
  nowhere.  Their states are masked to zero or they are finite, and no
  reduction crosses rows, so they change no real row; their outputs are
  never read back.
* **Static inputs.**  The forward's inputs live in one device buffer in
  ``nn.pack_host``'s layout (``nn.device_buffer``); ``stage`` writes the
  rows and their zero pad into a page-locked buffer and copies it there
  with one ``non_blocking`` copy (``nn.parts_to_device(..., into=)``).
* **Capture on first sight.**  The first call of a graph runs the forward
  eagerly on the static inputs (its answer, and the warm-up that loads
  every kernel before capture), then captures it into the estimator's one
  memory pool (``torch.cuda.graph_pool_handle``).  Later calls replay it.
  The user's forward looks up what it calls when it runs, so what a capture
  records is what the eager path would run then.
* **Stream order.**  Staging, replay and the readback queued right behind it
  (``estimator._queue_host``) share the one stream, so call i + 1's inputs
  land after replay i has read them, and call i's readback runs before
  replay i + 1 overwrites the output: deferred calls queued on one graph
  each read their own answers.  Graphs of one pool may share scratch
  memory, which is safe because replays never overlap and each output is
  read back before the next replay of any graph.
* **Counters.**  ``cache.graph.miss`` counts a first sight (the estimator),
  ``cache.graph.hit`` a replay, ``cache.graph.failed`` a capture that
  failed, over both users.  The launches of a capture go to its thread's
  tally (``obs.capture_tally``), not to the ``<kernel>.launches``
  counters, and each replay adds them there, so the counters still count
  the kernels that ran.  A capture synchronizes the device and collects
  garbage first (``torch.cuda.graph``'s own preparation), once per graph.

The eager path stays for the CPU, for ``estimate`` of a single unbatched
graph, and for a graph whose capture failed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import nn, obs
from repro_torch.core.gnn import MergedConstants, apply_gnn_merged_rows
from repro_torch.serve.stacking import StackedEnsembles

ROW_BUCKET = 256  # a graph's rows round up to a multiple of this


def row_bucket(n: int) -> int:
    """The rows a graph's batch or chunk of ``n`` rows runs at: ``n`` rounded up to a multiple of ``ROW_BUCKET``."""
    return max(1, -(-int(n) // ROW_BUCKET)) * ROW_BUCKET


def zero_padded(arrays: Sequence[np.ndarray], rows: int):
    """Each array as ``nn.parts_to_device`` parts, padded along its first
    axis to ``rows`` with zeros of its dtype."""
    return [[a, np.zeros((rows - len(a),) + a.shape[1:], a.dtype)] for a in arrays]


def padded_parts(skel_id: np.ndarray, a_place: np.ndarray, rows: int):
    """A merged chunk's ``skel_id`` and ``a_place`` as ``nn.parts_to_device``
    parts, each padded to ``rows`` with zeros: skeleton 0, placed nowhere."""
    return zero_padded([skel_id, a_place], rows)


class ForwardGraph:
    """A forward over static inputs of one (stacked ensemble, row bucket,
    layout), its static inputs and, once captured, its CUDA graph and output.
    ``forward(stacked, static)`` is the user's forward over the static inputs
    (``static``: the views of ``buf``, in ``specs`` order)."""

    __slots__ = ("stacked", "rows", "buf", "static", "_forward", "pool", "graph", "out", "launches", "failed")

    def __init__(self, stacked: StackedEnsembles, rows: int, specs, device,
                 forward: Callable[[StackedEnsembles, list], torch.Tensor], pool):
        self.stacked, self.rows, self._forward, self.pool = stacked, rows, forward, pool
        self.buf, self.static = nn.device_buffer(specs, device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.failed = False

    def stage(self, parts: Sequence[Sequence[np.ndarray]]) -> None:
        """Queue host parts, padded to the bucket (``zero_padded``), into the
        static inputs: one page-locked copy (``nn.parts_to_device(..., into=)``)."""
        nn.parts_to_device(parts, self.buf.device, into=self.buf)

    def forward(self) -> torch.Tensor:
        """The eager forward over the static inputs."""
        return self._forward(self.stacked, self.static)

    def run(self) -> Tuple[torch.Tensor, str]:
        """The forward over the staged inputs, with no autograd, and how it
        ran: ``"hit"`` (a replay), ``"capture"`` (eager, then captured for
        later calls) or ``"eager"`` (the capture failed)."""
        if self.failed:
            return self.forward(), "eager"
        if self.graph is not None:
            obs.count("cache.graph.hit")
            self.graph.replay()
            for k, v in self.launches.items():
                obs.count(k, v)
            return self.out, "hit"
        out = self.forward()
        self._capture()
        return out, "capture" if self.graph is not None else "eager"

    def _capture(self) -> None:
        """Capture the forward into ``pool``; each kernel launched in it is
        kept in ``launches`` (``obs.capture_tally``), for every replay to
        count.  A capture that fails (``cache.graph.failed``) leaves this
        graph eager for good; running out of device memory is raised."""
        graph = torch.cuda.CUDAGraph()
        try:
            with obs.capture_tally() as tally, torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                out = self.forward()
        except torch.OutOfMemoryError:
            raise
        except RuntimeError:
            self.failed = True
            obs.count("cache.graph.failed")
        else:
            self.graph, self.out, self.launches = graph, out, tally


def merged_graph(stacked: StackedEnsembles, consts: MergedConstants, rows: int, place_shape: Tuple[int, ...],
                 device, pool) -> ForwardGraph:
    """``score_many``'s graph of one (merged group, stacked ensemble, row
    bucket): ``apply_gnn_merged_rows`` over the static ``skel_id`` and
    ``a_place`` -> ``(E, rows)``."""
    cfg = stacked.cfgs[0].gnn
    return ForwardGraph(
        stacked, rows, [(np.int64, (rows,)), (np.float32, (rows, *place_shape))], device,
        lambda st, static: apply_gnn_merged_rows(st.params, consts, *static, cfg), pool,
    )
