"""The plain PyTorch versions of B8, RMSNorm: the port's arithmetic of
``layers.apply_norm``'s rmsnorm branch and of ``_rms(x) * scale`` before
B8 (the JAX package's ``models/layers.py:57-67`` and ``:241-243``,
``models/mla.py:70``), and the closed form of their gradient.

``x`` is ``(..., width)`` in its own dtype, read in float32; ``scale`` is
float32 ``(width,)`` and ``offset`` 1.0 (``apply_norm``: ``1 + scale``) or
0.0 (``_rms(x) * scale``).  Each row's ``rstd = rsqrt(mean(x^2) + eps)``
is float32 ``(...)``.  The kernel computes the same expressions in the
same order (``csrc/rms_norm.cu``); only its row sums add in another
order."""

from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: ``y = (x * rstd * (offset + scale)).to(x.dtype)``."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * (offset + scale)
    return y.to(x.dtype), rstd[..., 0]


def rms_norm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                     dy: torch.Tensor, offset: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of :func:`rms_norm_ref` for the output gradient
    ``dy`` (x's shape and dtype): with ``g = dy * (offset + scale)``,
    ``dx = rstd * (g - x * (rstd^2 * sum(g * x) / width))`` in x's dtype,
    and ``dscale`` float32 ``(width,)``, the rows' ``dy * (x * rstd)``
    summed."""
    width = x.shape[-1]
    xf, dyf, r = x.float(), dy.float(), rstd[..., None]
    g = dyf * (offset + scale)
    c = (g * xf).sum(dim=-1, keepdim=True)
    dx = r * (g - xf * (r * r * c / width))
    dscale = (dyf * (xf * r)).reshape(-1, width).sum(dim=0)
    return dx.to(x.dtype), dscale
