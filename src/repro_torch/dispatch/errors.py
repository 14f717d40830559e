"""Error types of the port's dispatch plane.

The JAX package's ``dispatch/errors.py`` holds the whole taxonomy; only
the base class and the drain timeout, which the serving engine raises, are
ported so far.  The rest comes with the control-plane slice (ROADMAP.md,
Queue 1 item 6).
"""

from __future__ import annotations


class DispatchError(RuntimeError):
    """Base class for every error the dispatch plane raises on purpose.

    Catch this to handle any typed dispatcher failure — backpressure,
    admission rejection, worker faults, lifecycle violations, journal
    corruption — with one handler."""


class DrainTimeoutError(DispatchError):
    """Raised when a drain exhausts its step/time budget with work pending."""
