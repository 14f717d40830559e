"""Hopper RMSNorm (B8), the backward: ctypes wrapper over
``csrc/rms_norm.cu``'s ``rms_backward``.

:func:`rms_norm_bwd` is one call of two kernels (:func:`kernel.choose_backward`
plans them).  The rows: each row's x and dy read once into the registers
of the team that takes it, dx written in x's dtype, each thread's columns'
d(scale) sums kept in registers over its rows; the block's teams, then a
thread-block cluster's CTAs, add their sums in a fixed order into one
partial row a cluster.  Then ``rms_dscale_kernel`` sums the clusters' rows
in a fixed order into ``dscale``.  Both go by programmatic dependent
launch, so each launch overlaps the tail of the kernel before it.  No atomics: the same inputs give the
same bits.  The plain version is :func:`.ref.rms_norm_bwd_ref`; the
routing, the checks and the layout are the forward's (:mod:`.kernel`).
``launches`` counts calls (two kernels each).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import run_plain, takes_plain

from . import kernel
from .ref import rms_norm_bwd_ref

launches = 0


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                 offset: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)``: dx of x's shape (contiguous) and dtype, dscale
    float32 ``(width,)``, for the output gradient ``dy`` (x's shape and
    dtype) and the forward's ``rstd`` (float32, x's leading shape)."""
    global launches
    kernel.check(x, scale, offset)
    for what, t in (("dy", dy), ("rstd", rstd)):
        takes_plain(t)
        if t.device != x.device:
            raise ValueError(f"rms_norm: {what} on {t.device}, x on {x.device}")
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"rms_norm: dy {dy.dtype} {tuple(dy.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    if rstd.dtype != torch.float32 or rstd.shape != x.shape[:-1]:
        raise ValueError(f"rms_norm: rstd must be float32 {tuple(x.shape[:-1])}; got "
                         f"{rstd.dtype} {tuple(rstd.shape)}")
    if takes_plain(x):
        with torch.no_grad():
            return run_plain(functools.partial(rms_norm_bwd_ref, offset=offset), x, scale, rstd,
                             dy)
    width = x.shape[-1]
    xr, dr = kernel.rows_of(x), kernel.rows_of(dy)
    r = rstd.contiguous().view(-1)
    rows = xr.shape[0]
    dx = torch.empty(rows, width, dtype=x.dtype, device=x.device)
    if not rows:
        return dx.view(x.shape), torch.zeros(width, dtype=torch.float32, device=x.device)
    vec = kernel.aligned(xr, dr, dx)
    plan = kernel.choose_backward(rows, width, x.element_size(), bool(vec))
    partial = torch.empty(plan.parts, width, dtype=torch.float32, device=x.device)
    dscale = torch.empty(width, dtype=torch.float32, device=x.device)
    w = scale.contiguous()
    err = kernel.library(x.device).rms_backward(
        xr.data_ptr(), xr.stride(0), dr.data_ptr(), dr.stride(0), r.data_ptr(), rows, width,
        w.data_ptr(), offset, int(x.dtype == torch.bfloat16), vec, plan.items, plan.stages,
        plan.threads, plan.grid, plan.cluster, plan.smem, dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), kernel.stream(x.device))
    kernel.raise_on(err, "rms_backward")
    launches += 1
    return dx.view(x.shape), dscale
