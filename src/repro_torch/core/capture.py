"""Capture/replay exclusion: CUDA-graph captures never overlap device work
that other threads of the process drive through the serving path.

Under the ``AsyncDispatcher`` a lane that registers seals (captures) its
steps on the registering thread while other lanes' steppers replay theirs,
and a schedule-cache eviction re-seals on a stepper.  A capture in CUDA's
global mode forbids the whole process the calls that may synchronise
(``cudaMalloc``, a blocking copy, a synchronize), and such a call from
another thread fails with "operation not permitted when stream is
capturing" and invalidates the capture.

Two measures keep them apart:

* :data:`CAPTURE_LOCK`, a process-wide reader-writer lock.  A seal (the
  warm-up and the capture) holds it exclusively; a step's device sections
  (inputs copied in, the replay, the result read back) hold it shared.  A
  seal waits for the replays in flight to finish, and replays wait while a
  seal is waiting or running, so no stepper touches the card during a
  capture.  Writers take precedence, so a stream of replays cannot starve a
  registration.
* captures run in ``thread_local`` error mode on ``torch.cuda.graph``'s
  private stream, so a thread outside the serving path (a user callback,
  or a Nimble plan's launch, which takes no shared section: its per-call
  host time is what Nimble measures) that touches the card during a
  capture gets no error and does not break it.

Every capture of the port goes through :func:`capture_graph`, which also
holds Python's cyclic garbage collector off for the capture's length: an
automatic collection inside a capture may free a reference cycle that
holds another CUDA graph (a sealed engine dropped while another lane
seals, an evicted bucket), and CUDA refuses to destroy a graph while a
stream captures, which ends the capture in an error.  Thread-local mode
still checks the capturing thread's own calls, and the collector runs on
whichever thread allocates.

A thread that holds a shared section must not seal inside it: builds happen
between sections (the engine fetches a sealed step before it opens the
section that replays it), and :meth:`CaptureLock.capturing` raises rather
than deadlock if that rule is broken.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Iterator

import torch

#: the error mode every capture of the port uses (see the module docstring)
CAPTURE_ERROR_MODE = "thread_local"


@contextlib.contextmanager
def capture_graph(graph: "torch.cuda.CUDAGraph", *,
                  capture_error_mode: str = CAPTURE_ERROR_MODE, **kw) -> Iterator[None]:
    """``torch.cuda.graph(graph, capture_error_mode=..., **kw)`` with
    Python's cyclic garbage collector off for the whole capture; the
    collector's previous state comes back on exit, an exception included
    (see the module docstring)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode=capture_error_mode, **kw):
            yield
    finally:
        if enabled:
            gc.enable()


class CaptureLock:
    """Writer-preferring reader-writer lock: exclusive for captures, shared
    for replays.  Shared sections re-enter on one thread; the counters
    (``captures``, ``replays``, ``capture_wait_s``) are for reports."""

    def __init__(self) -> None:
        self._cv = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = 0                 # ident of the capturing thread
        self._writers_waiting = 0
        self._local = threading.local()
        self.captures = 0
        self.replays = 0
        self.capture_wait_s = 0.0       # time seals spent waiting for replays

    @contextlib.contextmanager
    def replaying(self) -> Iterator[None]:
        """Shared section: device work that must not overlap a capture."""
        depth = getattr(self._local, "depth", 0)
        if depth:
            self._local.depth = depth + 1
            try:
                yield
            finally:
                self._local.depth = depth
            return
        with self._cv:
            while self._writer or self._writers_waiting:
                self._cv.wait()
            self._readers += 1
            self.replays += 1
        self._local.depth = 1
        try:
            yield
        finally:
            self._local.depth = 0
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        """Exclusive section: a seal's warm-up and capture."""
        me = threading.get_ident()
        if self._writer == me:
            yield                        # a seal nested in a seal
            return
        if getattr(self._local, "depth", 0):
            raise RuntimeError(
                "a CUDA graph capture was started inside a replay section of "
                "the same thread; seal before replaying"
            )
        t0 = time.perf_counter()
        with self._cv:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cv.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = me
            self.captures += 1
            self.capture_wait_s += time.perf_counter() - t0
        try:
            yield
        finally:
            with self._cv:
                self._writer = 0
                self._cv.notify_all()

    def stats(self) -> dict:
        """Counters: captures, shared sections entered, seconds seals spent
        waiting for replays to finish."""
        with self._cv:
            return {
                "captures": self.captures,
                "replays": self.replays,
                "capture_wait_s": self.capture_wait_s,
            }


#: the process-wide lock every seal and every serving replay goes through
CAPTURE_LOCK = CaptureLock()
