"""The plain PyTorch versions of B9, rotary position embeddings: the port's
arithmetic of ``layers.apply_rope`` before B9 (the JAX package's
``models/layers.py:74-88``), split into the tables, which the kernel's
wrapper computes with this code too, and the rotation, which the kernel
computes.

``x`` is ``(..., S, heads, head_dim)``; its last dimension is split in
halves ``x1 | x2`` and rotated in float32 by each position's angles,
``[x1 * cos - x2 * sin, x2 * cos + x1 * sin]``, rounded once to x's
dtype.  The backward is the same rotation by ``-sin``."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)``, float32 ``(head_dim / 2,)``."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of the angles ``positions * freqs``, float32
    ``(..., S, head_dim / 2)`` for ``positions`` ``(..., S)``, on the
    positions' device."""
    angles = positions[..., :, None].float() * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(angles), torch.sin(angles)


def rotary_ref(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, negate: bool = False
               ) -> torch.Tensor:
    """x rotated by the tables (``(..., S, head_dim / 2)``, broadcast over
    the heads), by ``-sin`` with ``negate``: x's shape and dtype."""
    c = cos[..., None, :]
    s = (-sin if negate else sin)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
