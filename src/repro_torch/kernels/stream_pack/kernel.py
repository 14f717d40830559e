"""Hopper stream_pack: ctypes wrapper over ``csrc/stream_pack.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
(``repro/kernels/stream_pack/kernel.py::stream_pack_matmul``): k
independent ``(M, K) @ (K, N)`` products in one launch, float32
accumulation, output in ``x.dtype``.  It keeps the reference's
``block_m/block_n/block_k`` arguments and their ``ValueError`` when a
dimension does not divide its (clamped) block; the check is plain Python
and does not choose the CUDA tile, which masks its ragged edge.  ``x`` may
be a lane broadcast (lane stride 0) of one ``(M, K)`` matrix, which the
kernel reads once per block and never copies.  The library is built with
``nvcc`` for ``sm_90a`` at first launch (see :mod:`repro_torch.kernels.build`);
the kernel launches on PyTorch's current stream and allocates nothing, so a
CUDA graph captures it like any other operator.

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture (which does not run it).  A
CUDA-graph replay runs it again without passing through here.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "stream_pack.cu"
MAX_GRID_YZ = 65535
TILE_M = 64                    # the CUDA tile's rows (csrc BM)

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        fn = build.load(SOURCE).stream_pack_matmul
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_blocks(M: int, N: int, K: int, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128) -> tuple[int, int, int]:
    """The TPU kernel's block contract: blocks clamp to the dimensions, and
    each dimension must divide its block.  Returns the clamped blocks."""
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M},{N},{K}) must divide blocks ({bm},{bn},{bk})")
    return bm, bn, bk


def stream_pack_matmul(
    x: torch.Tensor,            # (lanes, M, K); lane stride 0 for a shared x
    w: torch.Tensor,            # (lanes, K, N)
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; raises on anything else."""
    global launches
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x and w must be 3-d; got {tuple(x.shape)} and {tuple(w.shape)}")
    lanes, M, K = x.shape
    if w.shape[0] != lanes or w.shape[1] != K:
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    N = w.shape[2]
    check_blocks(M, N, K, block_m, block_n, block_k)
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"stream_pack kernel needs CUDA tensors; {name} is on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != x.dtype:
            raise ValueError(f"x and w must both be float32 or both bfloat16; {name} is {t.dtype}")
    if w.device != x.device:
        raise ValueError(f"x and w must share one device; w is on {w.device}")
    if min(lanes, M, N, K) < 1:
        raise ValueError(f"empty product: lanes {lanes}, M {M}, N {N}, K {K}")
    if lanes > MAX_GRID_YZ or -(-M // TILE_M) > MAX_GRID_YZ:
        raise ValueError(f"lanes {lanes} or M {M} exceeds the launch grid")
    if (K > 1 and x.stride(2) != 1) or (M > 1 and x.stride(1) != K):
        raise ValueError(f"x's rows must be contiguous; strides {x.stride()}")
    x_lane_stride = 0 if lanes == 1 else x.stride(0)
    if x_lane_stride not in (0, M * K):
        raise ValueError(f"x's lane stride must be 0 (shared) or M*K; got {x_lane_stride}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    out = torch.empty((lanes, M, N), dtype=x.dtype, device=x.device)
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        lanes, M, N, K, x_lane_stride, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stream_pack launch failed: CUDA error {err}")
    launches += 1
    return out
