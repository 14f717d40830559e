"""Unified error taxonomy for the port's dispatch plane (a copy of the JAX
package's ``dispatch/errors.py``; the worker plane adds no class of its own:
a ``fork`` start after CUDA is initialised is refused as
:class:`~repro_torch.dispatch.workers.WorkerSetupError`).

Every failure the dispatcher can surface — backpressure, admission
control, drain timeouts, worker-plane faults, lifecycle violations,
journal corruption — derives from one :class:`DispatchError` base so a
caller can write ``except DispatchError`` once instead of enumerating
the zoo.  The base extends :class:`RuntimeError` because every one of
these classes historically did; existing ``except RuntimeError`` (and
the narrower historical types, which live on as subclasses) keep
working unchanged.

The hierarchy::

    DispatchError(RuntimeError)
    ├── QueueFullError          submit-side backpressure (dispatcher.py)
    ├── DrainTimeoutError       drain exhausted its budget (dispatcher.py)
    ├── AdmissionRejected       SLO admission / shedding (slo.py)
    ├── IllegalTransition       lifecycle state-machine violation
    ├── JournalCorrupt          unreadable / torn request journal
    ├── FaultInjected           a FaultInjector fired (tests only)
    └── WorkerError             worker-plane faults (workers.py)
        ├── WorkerSetupError
        ├── WorkerCrashed
        └── WorkerTimeout

``QueueFullError``/``DrainTimeoutError`` are still importable from
``repro_torch.dispatch.dispatcher``, ``AdmissionRejected`` from
``repro_torch.dispatch.slo``, and the worker family from
``repro_torch.dispatch.workers`` — those modules re-export the classes defined
(or re-parented) here, so no call site changes.
"""

from __future__ import annotations


class DispatchError(RuntimeError):
    """Base class for every error the dispatch plane raises on purpose.

    Catch this to handle any typed dispatcher failure — backpressure,
    admission rejection, worker faults, lifecycle violations, journal
    corruption — with one handler."""


class QueueFullError(DispatchError):
    """Raised by :meth:`Dispatcher.submit` when the bounded queue is full."""


class DrainTimeoutError(DispatchError):
    """Raised when a drain exhausts its step/time budget with work pending."""


class IllegalTransition(DispatchError):
    """A request or lane was asked to make a lifecycle transition the
    state machine forbids (e.g. ``COMPLETED → QUEUED``).

    Attributes: ``entity`` (``"request"`` or ``"lane"``), ``key`` (rid or
    lane name), ``src`` and ``dst`` (the offending transition)."""

    def __init__(self, entity: str, key: object, src: str, dst: str) -> None:
        super().__init__(
            f"illegal {entity} transition {src!r} -> {dst!r} ({entity}={key!r})"
        )
        self.entity = entity
        self.key = key
        self.src = src
        self.dst = dst


class JournalCorrupt(DispatchError):
    """The request journal could not be read back consistently (torn
    write beyond WAL recovery, schema damage, or an unpicklable lane
    spec).  Carries ``path`` when known."""

    def __init__(self, msg: str, *, path: str = "") -> None:
        super().__init__(msg)
        self.path = path


class FaultInjected(DispatchError):
    """Raised by a :class:`~repro_torch.dispatch.journal.FaultInjector` hook —
    the deterministic stand-in for a crash in recovery tests.  Never
    raised in production paths unless an injector is installed."""
