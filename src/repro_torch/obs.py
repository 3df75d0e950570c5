"""The port's one tracer: named host spans and integer counters.

``span(name, **attrs)`` times a piece of host work, ``count(name, n)`` adds
to a counter (``launch(kernel)`` to a kernel's launch counter); ``records()``
and ``counters()`` read them back.

Spans are on exactly while ``torch.profiler`` records, in every thread:
the check reads the process-wide flag that ``torch.autograd.profiler`` sets
when a profiler starts and clears when it stops
(``torch._C._autograd._profiler_enabled()`` answers per thread, and reads
False on a thread the profiler was not started on, such as
``PlacementService``'s worker).  Off, a span is one check and a shared null
context: it opens no profiler range (a
``record_function`` costs microseconds even with no profiler running) and
keeps nothing.  On, each span

* opens a profiler range of its name (``_RecordFunctionFast``, the C++ form
  of ``record_function``: about a microsecond to open and close, and not
  copied onto the device's timeline), so it is an event of the profiler's
  own trace, on the clock of its device events, and ``export_chrome_trace``
  carries it;
* keeps a record (``Record``) in a bounded in-memory buffer, stamped with
  ``time.time_ns()``, the clock the profiler's host events carry.

A new buffer starts each time the profiler starts, so after a profiled
stretch ``records()`` holds that stretch and nothing older.  Parents are
tracked per thread.  A span opened with no parent on its thread starts a
new call id, and its children share it; ``current_call()`` hands the id on,
so that a deferred half of the same call (``span(..., call=id)``) joins it.

Counters are integer adds under one lock, always on (kernel launches, cache
hits and misses).  Anything that costs work to compute, such as a count of
real rows or the host allocator's statistics, the caller computes only when
its span records (``span(...).on``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 1 << 16  # a profiled stretch keeps at most this many spans (the newest)

_range = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    """One finished span.  ``parent`` is the enclosing span's ``id`` on the
    same thread (None at a root); ``call`` is the call id it belongs to."""

    id: int
    name: str
    call: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class _Null:
    """The span when tracing is off: enters and sets nothing."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()
_records: deque = deque(maxlen=MAX_RECORDS)
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()


def _on_profiler_start(start=_profiler._run_on_profiler_start):
    start()
    _records.clear()  # a fresh buffer for the stretch that starts


if not getattr(_profiler._run_on_profiler_start, "_obs", False):
    _on_profiler_start._obs = True
    _profiler._run_on_profiler_start = _on_profiler_start


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("id", "name", "call", "parent", "attrs", "start_ns", "_rf", "_stack")
    on = True

    def __init__(self, name: str, call: Optional[int], attrs: dict):
        self.name, self.call, self.attrs = name, call, attrs

    def __enter__(self):
        st = self._stack = _stack()
        parent = st[-1] if st else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if self.call is None:
            self.call = parent.call if parent is not None else next(_calls)
        self._rf = _range(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()  # after the enter: the profiler stamps its event inside it
        st.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        self._rf.__exit__(*exc)
        end_ns = time.time_ns()
        _records.append(Record(self.id, self.name, self.call, self.parent, threading.get_ident(),
                               self.start_ns, end_ns, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a cache hit, row counts)."""
        self.attrs.update(attrs)


def span(name: str, call: Optional[int] = None, **attrs):
    """A context manager timing ``name``; ``as`` gives an object whose
    ``set(**attrs)`` adds attributes and whose ``on`` says whether it records.
    ``call`` joins the span to an earlier span's call id (``current_call``)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, call, attrs)


def current_call() -> Optional[int]:
    """The call id of this thread's innermost open span (None when off or at no span)."""
    if not _profiler._is_profiler_enabled:
        return None
    st = getattr(_local, "stack", None)
    return st[-1].call if st else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def launch(kernel: str) -> None:
    """Count one launch of ``kernel`` in ``<kernel>.launches``.  A launch
    inside a CUDA graph's capture runs only when the graph replays: it goes
    to this thread's open ``capture_tally`` instead, and is not counted at
    all under a capture that keeps no tally."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        name = kernel + ".launches"
        tally[name] = tally.get(name, 0) + 1
    elif not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()):
        count(kernel + ".launches")


@contextlib.contextmanager
def capture_tally():
    """While open, this thread's kernel launches (``launch``) go to the
    yielded dict of ``<kernel>.launches`` counts, not to the counters: a
    graph's capture keeps the counts that each replay adds."""
    tally: Dict[str, int] = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def records() -> Tuple[Record, ...]:
    """The spans of the latest profiled stretch, in the order they ended."""
    return tuple(_records)


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _counters_lock:
        return dict(_counters)
