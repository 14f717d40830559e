"""The port's dispatch layer so far: shape bucketing, the schedule cache
and the error base.  The dispatcher, fairness, SLO plane, worker plane and
journal wait for the control-plane slice (ROADMAP.md, Queue 1 item 6)."""

from .bucketing import (
    BucketingPolicy,
    ExactBucketing,
    ExplicitBuckets,
    PowerOfTwoBuckets,
    make_policy,
)
from .cache import CacheStats, MemoryBudget, ScheduleCache
from .errors import DispatchError, DrainTimeoutError

__all__ = [
    "BucketingPolicy",
    "CacheStats",
    "DispatchError",
    "DrainTimeoutError",
    "ExactBucketing",
    "ExplicitBuckets",
    "MemoryBudget",
    "PowerOfTwoBuckets",
    "ScheduleCache",
    "make_policy",
]
