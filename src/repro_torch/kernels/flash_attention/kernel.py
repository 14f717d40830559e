"""Hopper flash attention: ctypes wrapper over ``csrc/flash_attention.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
(``repro/kernels/flash_attention/kernel.py::flash_attention``), with the
same signature minus the TPU's block sizes and interpret mode.  The kernel
masks the ragged edge, so any ``Sq`` and ``Skv`` are accepted.  The library
is built with ``nvcc`` for ``sm_90a`` at first launch (see
:mod:`repro_torch.kernels.build`); the kernel launches on PyTorch's current
stream, so it is captured by a CUDA graph like any other operator.

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture (which does not run it).  A
CUDA-graph replay runs it again without passing through here.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        fn = build.load(SOURCE).flash_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(
    q: torch.Tensor,           # (BH, Sq, hd)   batch·q_heads flattened
    k: torch.Tensor,           # (BH_kv, Skv, hd)
    v: torch.Tensor,           # (BH_kv, Skv, hd)
    *,
    group: int = 1,            # q heads per kv head (GQA): BH == BH_kv * group
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; raises on anything else."""
    global launches
    BH, Sq, hd = q.shape
    BHK, Skv, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"q, k and v must share one device; {name} is on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must all be float32 or all bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 3 or t.shape[-1] != hd:
            raise ValueError(f"{name} must be (rows, seq, {hd}); got {tuple(t.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if group < 1 or BH != BHK * group:
        raise ValueError(f"BH {BH} != BH_kv {BHK} * group {group}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty sequence: Sq {Sq}, Skv {Skv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    # the kernel reads 16-byte vectors; a view into a larger tensor may
    # start off that boundary, a fresh copy never does
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    fn = _kernel()
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), BH, group, Sq, Skv, hd,
        float(scale), float(softcap), int(bool(causal)), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return o
