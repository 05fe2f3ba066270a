"""Structured logging, per-phase timing records and the process's span tree.

The reference narrates progress with unstructured ``std::cout`` and times
phases with ``pcl::console::TicToc`` (Segmentation.cpp:26-47,
Registration.cpp:91-184) without recording anything.  Here phase timings are
collected into a structured record that callers can dump as JSON metrics,
and logging goes through the standard library logger
``piecewise_icp_torch``.  The port's own copy of
``piecewise_icp_tpu/utils/logging.py``, extended by a span tree:

* :data:`GLOBAL_TIMER` (a :class:`SpanTimer`) records every span the
  program opens with :func:`gphase`, and every phase of a
  :class:`PhaseTimer` made with a ``span_prefix``: its name, length, start
  and end on the clock of ``time.time_ns()`` (that of the
  ``torch.profiler`` timestamps), its id, its parent and its request (the
  outermost span open on its thread), its thread, and the counters that
  accrued while it was the innermost open span of its thread.
* The counters are made where the work happens: :func:`to_host` and
  :func:`note_sync` count ``syncs`` (each point where the host waits for a
  CUDA stream), :func:`to_device` counts ``h2d`` and ``h2d_bytes`` (each
  upload to a CUDA device, which, from pageable host memory, also
  synchronises the stream and so counts under ``syncs`` too).  Work on
  the CPU is not counted.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import threading
import time
from typing import Dict, List

import torch

log = logging.getLogger("piecewise_icp_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[pwicp] %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)

# the records GLOBAL_TIMER keeps: a pair closes about 40 spans, so the
# newest ~500 pairs of a process that registers pairs for days, in ~13 MB
SPAN_RECORDS = 20_000


class PhaseTimer:
    """Collects wall-clock timings per named phase.  With ``span_prefix``
    each phase also opens the span ``<span_prefix><phase>`` of
    :data:`GLOBAL_TIMER`; the records here keep the bare phase name."""

    def __init__(self, span_prefix: str | None = None) -> None:
        self.records: List[Dict] = []
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        span = (contextlib.nullcontext() if self.span_prefix is None
                else gphase(self.span_prefix + name, **meta))
        with span:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append({"phase": name,
                                     "seconds": time.perf_counter() - t0,
                                     **meta})

    def total(self) -> float:
        return sum(r["seconds"] for r in self.records)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out


class _Open:
    """A span while it is open: its id, its request and its counters."""

    __slots__ = ("id", "request", "counts")

    def __init__(self, sid: int, request: int) -> None:
        self.id = sid
        self.request = request
        self.counts: Dict[str, int] = {}


class SpanTimer(PhaseTimer):
    """The span tree of the process.

    Each closed span appends one record to ``records`` (the newest
    ``maxlen`` are kept): ``phase`` (the name), ``seconds`` and the span's
    meta, then ``id``, ``parent`` (the span open on the same thread when
    this one opened, or None), ``request`` (the outermost span open on that
    thread), ``thread`` (its name), ``start_ns`` and ``end_ns``
    (``time.time_ns()``) and ``counts``: the non-zero counters that accrued
    while this span was the innermost open span of its thread, so a
    parent's counts leave out its children's.  A count made with no span
    open on its thread is not recorded.  Each thread keeps its own stack
    of open spans.

    While ``annotate`` is above 0 (an operator's ``torch.profiler`` trace
    runs, :func:`annotated_spans`), each span also opens a
    ``torch.profiler.record_function`` range of its name."""

    def __init__(self, maxlen: int = SPAN_RECORDS) -> None:
        super().__init__()
        self.records = collections.deque(maxlen=maxlen)
        self.annotate = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        span = _Open(sid, sid if parent is None else parent.request)
        stack.append(span)
        ann = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ann:
            start_ns = time.time_ns()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                end_ns = time.time_ns()
                stack.pop()
                self.records.append({
                    "phase": name, "seconds": dt, **meta, "id": sid,
                    "parent": None if parent is None else parent.id,
                    "request": span.request,
                    "thread": threading.current_thread().name,
                    "start_ns": start_ns, "end_ns": end_ns,
                    "counts": span.counts})

    def count(self, **amounts: int) -> None:
        """Add ``amounts`` to the innermost open span of this thread."""
        stack = getattr(self._local, "stack", None)
        if stack:
            counts = stack[-1].counts
            for name, n in amounts.items():
                if n:
                    counts[name] = counts.get(name, 0) + n


# Pipeline stages record into it unconditionally (a span costs a few us);
# entry points may reset/read it for reporting.
GLOBAL_TIMER = SpanTimer()


def gphase(name: str, **meta):
    """Open the span ``name`` of the global timer."""
    return GLOBAL_TIMER.phase(name, **meta)


@contextlib.contextmanager
def annotated_spans():
    """Within the block every span also opens a
    ``torch.profiler.record_function`` range, so a profiler trace taken
    meanwhile shows the program's layers."""
    GLOBAL_TIMER.annotate += 1
    try:
        yield
    finally:
        GLOBAL_TIMER.annotate -= 1


def note_sync(t: torch.Tensor) -> None:
    """Count one synchronising call made at the caller's site on ``t``,
    where ``t`` is on CUDA: ``torch.nonzero``, an index that is a 0-dim
    device tensor, ``torch.linalg.solve``'s check of its factorisation."""
    if t.is_cuda:
        GLOBAL_TIMER.count(syncs=1)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; from a CUDA tensor a blocking read, counted under
    ``syncs``.  ``int``, ``float``, ``bool``, ``.item()``, ``.numpy()``
    and ``.tolist()`` of a device tensor go through here."""
    if t.is_cuda:
        GLOBAL_TIMER.count(syncs=1)
    return t.cpu()


def to_device(x, device: "torch.device | str",
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (a numpy array, a host tensor, a Python number or list) as a
    tensor of ``dtype`` (else ``torch.as_tensor``'s) on ``device``.  A copy
    to a CUDA device counts under ``h2d`` and ``h2d_bytes``, and, since a
    blocking copy from pageable memory waits for the stream, under
    ``syncs``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.is_cuda:
        GLOBAL_TIMER.count(h2d=1, h2d_bytes=t.numel() * t.element_size(),
                           syncs=1)
    return t
