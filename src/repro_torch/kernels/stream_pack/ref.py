"""Plain PyTorch version of stream_pack (the k-lane batched matmul)."""

from __future__ import annotations

import torch


def stream_pack_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (lanes, M, K), or (M, K) shared by every lane; w: (lanes, K, N) →
    (lanes, M, N).  Multiplies in float32 (set TF32 off on the card for a
    full-float32 reference) and casts the result to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)
