"""The plain PyTorch versions of B5, the token cross-entropy on one shard of
the vocabulary: the port's arithmetic of ``train_lib._row_nll`` before B5
(``logsumexp`` and the label's logit, the JAX package's
``training/train_lib.py:22-31``), split into what each shard computes on
its own columns and what its backward writes.

A shard holds the columns ``[start, start + width)`` of a vocabulary of
``vocab`` columns; ``logits`` is float32 ``(rows, width)`` and ``labels``
int64 ``(rows,)``.  A label below 0 is a masked token: it is taken as
column 0 (JAX's ``clip(labels, 0)``), and the mask is applied after the
loss, as in JAX.  A label at or past ``vocab`` gives a NaN label logit, as
JAX's ``take_along_axis`` fills an index out of bounds."""

from __future__ import annotations

import torch


def label_columns(labels: torch.Tensor, start: int, width: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's clamped label as a column of the shard, and whether the
    shard holds it."""
    col = labels.clamp(min=0) - start
    return col, (col >= 0) & (col < width)


def ce_partials_ref(logits: torch.Tensor, labels: torch.Tensor, start: int, vocab: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(m, s, gold)``, float32 ``(rows,)``: the shard's max, ``sum(exp(x
    - m))`` over the shard (0 where every column is -inf), and the logit
    at the clamped label where the shard holds that column (0 where it does
    not; NaN where the label is at or past ``vocab``)."""
    width = logits.shape[-1]
    col, inside = label_columns(labels, start, width)
    if width:
        m = torch.amax(logits, dim=-1)
        # a row whose columns are all -inf sums exp(-inf) = 0 (not NaN)
        shift = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        s = torch.sum(torch.exp(logits - shift[:, None]), dim=-1)
        gold = torch.gather(logits, -1, col.clamp(0, width - 1)[:, None])[:, 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
    else:           # an empty shard (an uneven split): no column to add
        m = logits.new_full(logits.shape[:-1], float("-inf"))
        s = gold = logits.new_zeros(logits.shape[:-1])
    gold = torch.where(labels >= vocab, torch.full_like(gold, float("nan")), gold)
    return m, s, gold


def ce_backward_ref(logits: torch.Tensor, labels: torch.Tensor, start: int, lse: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """``dlogits = g[:, None] * (exp(x - lse[:, None]) - onehot)``, float32
    ``(rows, width)``: the gradient of each row's ``lse - gold`` times
    ``g``, the one-hot set on the shard that holds the clamped label."""
    width = logits.shape[-1]
    col, _ = label_columns(labels, start, width)
    onehot = torch.arange(width, device=logits.device) == col[:, None]
    return g[:, None] * (torch.exp(logits - lse[:, None]) - onehot.float())
