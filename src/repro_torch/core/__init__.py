"""The port's share of the JAX package's ``core/``: so far only the
schedule key.  The scheduler, task graph and sealing wait for the core
slice (ROADMAP.md, Queue 1 item 4)."""

from .aot import ScheduleKey

__all__ = ["ScheduleKey"]
