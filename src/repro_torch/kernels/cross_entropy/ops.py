"""B5's autograd Function: each token's ``lse - gold`` over a vocabulary
whose columns may be split across devices.

Forward: :func:`.kernel.ce_partials` on the local shard, then
:func:`combine`: ``M = max_r m_r``, ``lse = M + log(sum_r s_r·exp(m_r -
M))`` and ``gold = sum_r gold_r`` over the shards r.  On one shard the
same arithmetic runs with no reduction (``M = m``, ``exp(0) = 1``), so a
mesh whose vocabulary axis has one device gives the unsharded bits.
Across shards the two reductions are functional collectives
(``_c10d_functional.all_reduce``): one max of ``m``, ``(rows,)``, and one
sum of ``(s·exp(m - M), gold)``, ``(rows, 2)`` float32, on each mesh
dimension that splits the vocabulary.  They are the only collectives of
the loss: no device gathers the logits, and a CUDA graph captures them.

Backward: one :func:`.kernel.ce_backward` on the local shard with the
saved ``lse``, and no collective: each shard's gradient needs only its own
columns and the row's ``lse``.  Masking stays with the caller, as in JAX:
a masked token's ``g`` is 0, and so is its gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed import all_reduce_over

from . import kernel


def combine(m: torch.Tensor, s: torch.Tensor, gold: torch.Tensor, reduce=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lse, gold)`` of the whole vocabulary from one shard's partials;
    ``reduce(t, op)`` reduces over the shards (None: this is the only
    shard).  An empty shard (``m = -inf``, ``s = 0``) adds nothing."""
    big = m if reduce is None else reduce(m, "max")
    part = torch.stack([s * torch.exp(m - big), gold], dim=-1)
    if reduce is not None:
        part = reduce(part, "sum")
    return big + torch.log(part[..., 0]), part[..., 1]


class TokenNLL(torch.autograd.Function):
    """``nll = lse - gold`` for each token of ``logits`` (float32 ``(...,
    width)``, the columns ``[start, start + width)`` of ``vocab``) against
    ``labels`` (int64, the leading shape), the shards reduced over the
    process groups ``groups``."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, vocab: int, groups: tuple):
        m, s, gold = kernel.ce_partials(logits, labels, start, vocab)
        lse, gold = combine(m, s, gold, all_reduce_over(groups))
        ctx.save_for_backward(logits, labels, lse)
        ctx.start, ctx.vocab = start, vocab
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return kernel.ce_backward(logits, labels, ctx.start, lse, g, ctx.vocab), None, None, \
            None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor, start: int = 0,
              vocab: int | None = None, groups: Sequence[str] = ()) -> torch.Tensor:
    """Each token's cross-entropy ``lse - gold``, float32 of the labels'
    shape (no mask applied).  Unsharded: ``start`` 0 and ``vocab`` the
    logits' width."""
    vocab = logits.shape[-1] if vocab is None else vocab
    return TokenNLL.apply(logits, labels, start, vocab, tuple(groups))
