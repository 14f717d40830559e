"""The gradient of flash attention on Hopper: ctypes wrapper over
``csrc/flash_attention_bwd.cu``.

Not a port of a TPU kernel: the JAX package differentiates its plain
attention through XLA and has no backward kernel.  :func:`attention_bwd`
takes what the forward saved (q, k, v, its output and its per-row
log-sum-exp) and the output's gradient, in either of the forward's layouts
(the model layout ``(B, S, heads, hd)`` read through its strides, or the
flat ``(BH, S, hd)``), and returns ``(dq, dk, dv)`` in the inputs' dtype
and shapes.  One call launches the library's three kernels (``D =
rowsum(dO * O)``, then dK/dV per key tile, then dQ per query tile) on
PyTorch's current stream, so a CUDA graph captures them; ``launches``
counts the calls, as the forward's wrapper does.  Its plain version is
:func:`..ref.flash_attention_bwd_ref`.

The bf16 kernels run their products on the tensor cores (``wgmma``) and
load q, k, v and dO by TMA, whose tensor maps need 16-byte aligned base
pointers and strides: like the forward, the wrapper passes its inputs
through :func:`.kernel.prepare`, which copies a tensor the kernels cannot
read in place (counted in ``kernel.layout_copies``).  The float32 kernels
run on the FMA units and read element-wise.

:func:`choose_launch`, plain Python, gives the three grids, the main
kernels' threads and their dynamic shared memory; the library sizes its
shared memory from the same formulas.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from . import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
ROWS, KEYS, THREADS = 64, 64, 256   # tiles; threads of the pre-pass and the float32 kernels
DOT_ROWS = THREADS // 32          # the float32 pre-pass: one warp per row
BF16_DOT_ROWS = THREADS // 8      # the bf16 pre-pass: 8 lanes per row, 16-byte loads
BF16_THREADS = 160                # bf16: one consumer warpgroup and one producer warp
DKDV_STAGES, DQ_STAGES = 3, 2     # bf16 rings: (Q, dO) stages of dK/dV, (K, V) stages of dQ
MAX_SMEM = 232448                 # bytes a CTA may opt into on an H100 (both fit)
# every kernel set of the library as (dtype, head_dim); each is three
# kernels (bwd_dot, bwd_dkdv, bwd_dq), and phase 19 of chip_smoke.py
# launches each of them
INSTANCES = tuple((dt, hd) for dt in ("bfloat16", "float32") for hd in kernel.HEAD_DIMS)

launches = 0
_fn = None
_STRIDES = ctypes.c_longlong * 24     # (batch, sequence, head) of q, k, v, o, dO, dq, dk, dv


@dataclass(frozen=True)
class BwdLaunch:
    """One call of the library: the grids of its three kernels (the
    pre-pass over ``DOT_ROWS`` float32 or ``BF16_DOT_ROWS`` bf16 rows per
    CTA; dK/dV per (batch * kv head, key tile); dQ per (batch * q head,
    query tile)), ``threads`` per CTA of the two main kernels and their
    dynamic shared memory."""

    dtype: str
    head_dim: int
    dot_grid: int
    dkdv_grid: tuple[int, int]
    dq_grid: tuple[int, int]
    threads: int
    dkdv_smem: int
    dq_smem: int

    @property
    def instance(self) -> tuple[str, int]:
        return self.dtype, self.head_dim


def dkdv_smem_bytes(head_dim: int, dtype: str) -> int:
    """Dynamic shared memory of a dK/dV CTA.  bf16 (csrc
    ``dkdv_bf16_smem``): the K and V tiles and ``DKDV_STAGES`` stages of Q
    and dO tiles at the padded width, each stage's 64 LSE and 64 D values,
    and 1 + 2 * stages mbarriers.  float32 (``dkdv_f32_smem``): K, V, Q and
    dO tiles, P and dS tiles, LSE and D, one padding column per tile row."""
    if dtype == "bfloat16":
        tile = 2 * ROWS * kernel.padded_head_dim(head_dim)
        return (tile * (2 + 2 * DKDV_STAGES) + 4 * 2 * ROWS * DKDV_STAGES
                + 8 * (1 + 2 * DKDV_STAGES))
    return 4 * (4 * 64 * (head_dim + 1) + 2 * ROWS * (KEYS + 1) + 2 * ROWS)


def dq_smem_bytes(head_dim: int, dtype: str) -> int:
    """Dynamic shared memory of a dQ CTA.  bf16 (csrc ``dq_bf16_smem``):
    the Q and dO tiles, ``DQ_STAGES`` stages of K and V tiles and 1 + 2 *
    stages mbarriers.  float32 (``dq_f32_smem``): Q, dO, K and V tiles, the
    dS tile, LSE and D."""
    if dtype == "bfloat16":
        tile = 2 * ROWS * kernel.padded_head_dim(head_dim)
        return tile * (2 + 2 * DQ_STAGES) + 8 * (1 + 2 * DQ_STAGES)
    return 4 * (4 * 64 * (head_dim + 1) + ROWS * (KEYS + 1) + 2 * ROWS)


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, NH: int, NKV: int, Sq: int, Skv: int, head_dim: int,
                  dtype: str) -> BwdLaunch:
    """The launch for q ``(B, Sq, NH, head_dim)`` and k/v ``(B, Skv, NKV,
    head_dim)`` of ``dtype``.  Plain Python.  Raises ``ValueError`` on a
    head dim or dtype the library lacks, or a grid past the launch
    limits."""
    if head_dim not in kernel.HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {kernel.HEAD_DIMS}")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"flash attention's backward takes float32 or bfloat16, not {dtype}")
    dot = -(-B * NH * Sq // (BF16_DOT_ROWS if dtype == "bfloat16" else DOT_ROWS))
    dkdv, dq = (B * NKV, -(-Skv // KEYS)), (B * NH, -(-Sq // ROWS))
    if (max(dot, dkdv[0], dq[0]) > kernel.MAX_GRID_X
            or max(dkdv[1], dq[1]) > kernel.MAX_GRID_Y):
        raise ValueError(f"B {B}, heads {NH}, Sq {Sq} or Skv {Skv} exceeds the launch grid")
    threads = BF16_THREADS if dtype == "bfloat16" else THREADS
    return BwdLaunch(dtype, head_dim, dot, dkdv, dq, threads, dkdv_smem_bytes(head_dim, dtype),
                     dq_smem_bytes(head_dim, dtype))


def launch_for(q: torch.Tensor, k: torch.Tensor) -> BwdLaunch:
    """The launch :func:`attention_bwd` makes for these tensors (4-d model
    layout, or 3-d flat)."""
    (B, Sq, NH), _ = kernel._bsh(q)
    (_, Skv, NKV), _ = kernel._bsh(k)
    return choose_launch(B, NH, NKV, Sq, Skv, q.shape[-1], str(q.dtype)[6:])


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        fn = build.load(SOURCE).flash_attention_bwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def attention_bwd(
    q: torch.Tensor,           # (B, Sq, NH, hd) or (BH, Sq, hd)
    k: torch.Tensor,           # (B, Skv, NKV, hd) or (BH_kv, Skv, hd)
    v: torch.Tensor,
    o: torch.Tensor,           # the forward's output, q's shape
    lse: torch.Tensor,         # (B, NH, Sq) or (BH, Sq) float32
    do: torch.Tensor,          # the output's gradient, q's shape
    *,
    group: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, fresh contiguous tensors of the inputs' shapes and
    dtype, from the backward kernels on CUDA tensors; an input the kernels
    cannot read in place is copied once (:func:`.kernel.prepare`).  Raises
    on anything else."""
    global launches
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} {q.dtype} on {q.device}; "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    (B, Sq, NH), _ = kernel._bsh(q)
    if (lse.dtype != torch.float32 or lse.numel() != B * NH * Sq or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous float32 of {B * NH * Sq} rows on q's device; "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    kernel._check(q, k, v, group, q.dim())     # the device last
    q, k, v, o, do = kernel.prepare(q, k, v, o, do)
    hd, Skv = q.shape[-1], k.shape[1]
    launch = choose_launch(B, NH, NH // group, Sq, Skv, hd, str(q.dtype)[6:])
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    D = torch.empty((B * NH * Sq,), dtype=torch.float32, device=q.device)
    strides = _STRIDES(*kernel.stride_args(q, k, v, o, do, dq, dk, dv))
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), B, NH, group, Sq, Skv, hd, strides,
        float(scale), float(softcap), int(bool(causal)), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err} ({launch})")
    launches += 1
    return dq, dk, dv
