"""The combine of B3's partials over a cache split over positions.

Each shard of the cache gives, per (batch row, query row, head), its
float32 output ``o_r`` normalized over the keys it holds and the
log-sum-exp ``lse_r`` of their scores (:func:`.kernel.decode_attention_partials`).
:func:`combine` weighs them: ``M = max_r lse_r``, ``w_r = exp(lse_r - M)``,
``out = sum_r w_r·o_r / sum_r w_r``, then the cast to q's dtype.  Across
devices the two reductions are functional collectives
(``_c10d_functional.all_reduce``): one max of the ``(B, S, NH)``
log-sum-exps and one sum of ``(B, S, NH, hd + 1)`` float32, each output
times its weight beside the weight, on each mesh dimension that splits the
positions.  They are the combine's only collectives: no device gathers the
cache or the scores, and a CUDA graph captures them.  On one shard the same
arithmetic runs with no reduction (``w = exp(0) = 1``): the whole-cache
kernel's bits.

A shard with no visible key adds nothing: the kernel gives it ``lse =
-inf`` and the plain version about ``NEG_INF``, both weighed by 0 beside a
shard that sees a key.  Where no shard sees one (no decode path makes such
a row; the step's token sees itself), each shard is weighed by its count
of positions: the plain versions' means of v over their shards combine to
JAX's mean of v over every position, and the kernel's zeros to 0, as the
whole-cache kernel writes.
"""

from __future__ import annotations

import torch

from .ref import NEG_INF


def over_stack(t: torch.Tensor, op: str) -> torch.Tensor:
    """A ``reduce`` for :func:`combine` over shards stacked on the first
    dimension of its inputs (one device holding them all): the max or the
    sum over that dimension, kept as a dimension of 1."""
    return t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)


def combine(out: torch.Tensor, lse: torch.Tensor, count, reduce=None,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """The attention output over every shard from this shard's partials:
    ``out`` ``(..., hd)`` and ``lse`` ``(...)`` float32, ``count`` the key
    positions this shard holds (a number, or a tensor that broadcasts
    against ``lse``), ``reduce(t, op)`` the reduction over the shards (None:
    this is the only shard; :func:`over_stack` for shards stacked on the
    first dimension; ``repro_torch.distributed.all_reduce_over`` across
    devices).  Float32, cast to ``dtype`` if given."""
    big = lse if reduce is None else reduce(lse, "max")
    weight = torch.where(big > NEG_INF / 2, torch.exp(lse - big), count)
    part = torch.cat([out * weight[..., None], weight[..., None]], dim=-1)
    if reduce is not None:
        part = reduce(part, "sum")
    res = part[..., :-1] / part[..., -1:]
    return res if dtype is None else res.to(dtype)
