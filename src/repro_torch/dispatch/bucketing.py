"""Shape bucketing: map request shapes onto cached schedule shapes.

Sealed steps are shape-specialized (a captured CUDA graph replays one set
of shapes), so serving arbitrary prompt lengths with a *finite* set of schedules
requires rounding each request up to a bucket and padding.  The policy is a
latency/compile-count trade-off:

* :class:`ExactBucketing`  — no padding, one schedule per distinct length
  (best step latency, unbounded compile count; rely on the LRU cache);
* :class:`PowerOfTwoBuckets` — lengths round up to the next power of two
  (log-many schedules, ≤2× padding waste);
* :class:`ExplicitBuckets` — a hand-tuned bucket list (what
  ``serving/engine.py`` hard-coded as ``prompt_buckets`` before this module
  generalized it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Union


class BucketingPolicy:
    """Maps a requested length to the schedule length that serves it.

    Policies are immutable (frozen dataclasses) and therefore safe to
    share across threads and engines."""

    def bucket(self, length: int) -> int:
        """The padded length whose sealed schedule serves ``length``
        (always ≥ ``length``; raises ``ValueError`` if unservable)."""
        raise NotImplementedError

    def static_buckets(self) -> Optional[tuple[int, ...]]:
        """The finite bucket family, if one exists (for eager warm-up);
        ``None`` when buckets are derived per-request (exact policy)."""
        return None

    def check(self, length: int) -> int:
        """Validate a request length (must be ≥ 1); returns it."""
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        return length


@dataclasses.dataclass(frozen=True)
class ExactBucketing(BucketingPolicy):
    """Every distinct length is its own bucket (zero padding)."""

    max_length: Optional[int] = None

    def bucket(self, length: int) -> int:
        """Identity (bounded by ``max_length`` when set)."""
        self.check(length)
        if self.max_length is not None and length > self.max_length:
            raise ValueError(
                f"length {length} exceeds max_length {self.max_length}"
            )
        return length


@dataclasses.dataclass(frozen=True)
class ExplicitBuckets(BucketingPolicy):
    """Smallest configured bucket that fits the request."""

    buckets: tuple[int, ...]

    def __post_init__(self):
        bs = tuple(sorted(set(int(b) for b in self.buckets)))
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        object.__setattr__(self, "buckets", bs)

    def bucket(self, length: int) -> int:
        """Smallest configured bucket ≥ ``length``."""
        self.check(length)
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"length {length} exceeds largest bucket {self.buckets[-1]}"
        )

    def static_buckets(self) -> tuple[int, ...]:
        """The configured bucket tuple (sorted, deduplicated)."""
        return self.buckets


@dataclasses.dataclass(frozen=True)
class PowerOfTwoBuckets(BucketingPolicy):
    """Round up to the next power of two within [min_bucket, max_bucket]."""

    min_bucket: int = 16
    max_bucket: int = 2048

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"invalid pow2 range [{self.min_bucket}, {self.max_bucket}]"
            )

    def bucket(self, length: int) -> int:
        """Next power of two ≥ ``length`` (from ``min_bucket`` up)."""
        self.check(length)
        b = self.min_bucket
        while b < length:
            b <<= 1
        if b > self.max_bucket:
            raise ValueError(
                f"length {length} exceeds max_bucket {self.max_bucket}"
            )
        return b

    def static_buckets(self) -> tuple[int, ...]:
        """All powers of two in [min_bucket, max_bucket]."""
        out = []
        b = self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b <<= 1
        return tuple(out)


PolicySpec = Union[BucketingPolicy, str, Sequence[int], None]


def make_policy(spec: PolicySpec) -> BucketingPolicy:
    """Coerce user-facing specs into a policy.

    ``None`` → pow2 defaults; ``"exact"`` / ``"pow2"`` / ``"pow2:MIN:MAX"``
    strings; an iterable of ints → :class:`ExplicitBuckets`.
    """
    if spec is None:
        return PowerOfTwoBuckets()
    if isinstance(spec, BucketingPolicy):
        return spec
    if isinstance(spec, str):
        name, _, rest = spec.partition(":")
        if name == "exact":
            return ExactBucketing()
        if name == "pow2":
            if rest:
                lo, _, hi = rest.partition(":")
                return PowerOfTwoBuckets(int(lo), int(hi or 2048))
            return PowerOfTwoBuckets()
        raise ValueError(f"unknown bucketing policy {spec!r}")
    if isinstance(spec, Iterable):
        return ExplicitBuckets(tuple(int(b) for b in spec))
    raise TypeError(f"cannot build a bucketing policy from {spec!r}")
