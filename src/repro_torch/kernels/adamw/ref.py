"""The plain PyTorch versions of B4, AdamW with global-norm clipping: the
port's arithmetic of ``optim/adamw.py`` before B4 (the JAX package's
``optim/adamw.py:29-71``), each a function the kernels compute."""

from __future__ import annotations

import torch


def sumsq_ref(leaves: list[torch.Tensor]) -> torch.Tensor:
    """Each leaf's float32 sum of squares, one value per leaf: ``(n,)``."""
    return torch.stack([torch.sum(torch.square(leaf.float())) for leaf in leaves])


def norm_scale_ref(sums: torch.Tensor, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The global norm, the square root of the leaves' sums added one by one
    in tree order (JAX's Python ``sum``), and the clip scale ``min(1,
    max_norm / (norm + 1e-9))`` (a true division, as JAX's)."""
    total = sum(sums.unbind(0)) if sums.numel() else sums.new_zeros(())
    norm = torch.sqrt(total)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9), max=1.0)
    return norm, scale


def bias_corrections_ref(step: torch.Tensor, b1: float, b2: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the int32 step counter in place and return ``1 - b1**step``
    and ``1 - b2**step`` in float32."""
    step.add_(1)
    s = step.float()
    return 1.0 - torch.pow(b1, s), 1.0 - torch.pow(b2, s)


def adamw_step_ref(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor, *,
                   scale: torch.Tensor | None, lr: float | torch.Tensor,
                   bc1: torch.Tensor, bc2: torch.Tensor, b1: float, b2: float, eps: float,
                   weight_decay: float) -> None:
    """One leaf's clip and update, in place: the gradient times ``scale``
    cast to its dtype (no clip when ``scale`` is None), the moments in
    float32, the update in float32 rounded to the parameter's dtype."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    gf = g.float()
    m.mul_(b1).add_(gf, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(gf, gf, value=1.0 - b2)
    del gf
    delta = torch.div(v, bc2).sqrt_().add_(eps)
    delta = torch.div(m, bc1).div_(delta)
    pf = p.float()
    delta.add_(pf, alpha=weight_decay)
    p.copy_(pf.sub_(delta.mul_(lr)))
