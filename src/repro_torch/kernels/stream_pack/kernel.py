"""Hopper stream_pack: ctypes wrapper over ``csrc/stream_pack.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
(``repro/kernels/stream_pack/kernel.py::stream_pack_matmul``): k
independent ``(M, K) @ (K, N)`` products in one launch, float32
accumulation, output in ``x.dtype``.  It keeps the reference's
``block_m/block_n/block_k`` arguments and their ``ValueError`` when a
dimension does not divide its (clamped) block; the check is plain Python
and does not choose the CUDA tile, which masks its ragged edge.
:func:`choose_launch`, also plain Python, chooses the CUDA kernel and its
tile; the library sizes the grid and the dynamic shared memory from the tile.  ``x`` may be a
lane broadcast (lane stride 0) of one ``(M, K)`` matrix, which the kernel
reads once per block and never copies.  The library is built with ``nvcc``
for ``sm_90a`` at first launch (see :mod:`repro_torch.kernels.build`); the
kernel launches on PyTorch's current stream and allocates nothing, so a
CUDA graph captures it like any other operator.

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture (which does not run it).  A
CUDA-graph replay runs it again without passing through here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "stream_pack.cu"
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65535
PANEL_MAX_SMEM = 65536       # the f32 panel's budget: three blocks fit on an SM
VECTOR_BYTES = 16            # one cp.async copy
RING_STAGES, RING_KC = 4, 64
F32_BN, BF16_BN = 16, 32     # the tiles' columns
F32_ROWS, BF16_ROWS = (8, 16, 32), (16, 32, 64)   # the tiles' rows, fitted to M
# every kernel of the library as (variant, bm, bn): csrc/stream_pack.cu
# instantiates the same tiles (kInstances), and phase 6 of chip_smoke.py
# launches each of them
INSTANCES = tuple(
    (f"{kind}/{loader}", bm, bn)
    for kind, rows, bn in (("f32_panel", F32_ROWS, F32_BN), ("f32_ring", F32_ROWS, F32_BN),
                           ("bf16_ring", BF16_ROWS, BF16_BN))
    for bm in rows for loader in ("vec", "elem"))

launches = 0
_lib = None
_ready_devices: set[int] = set()


@dataclass(frozen=True)
class Launch:
    """One launch of the library: ``variant`` names the kernel and its loader
    (``"f32_panel/vec"``: cp.async 16-byte copies; ``"/elem"``: masked
    element-wise loads), ``bm x bn`` the output tile, ``kc`` the K depth of
    one shared-memory stage and ``stages`` their number (1: the whole K
    panel in one load).  The library sizes the grid and the shared memory
    from the tile itself; ``grid`` and ``smem_bytes`` here are the same
    numbers, for the launch-limit check and for display."""

    variant: str
    bm: int
    bn: int
    kc: int
    stages: int
    grid: tuple[int, int, int]
    smem_bytes: int

    @property
    def vec(self) -> bool:
        return self.variant.endswith("/vec")

    @property
    def instance(self) -> tuple[str, int, int]:
        """The kernel of :data:`INSTANCES` this launch runs."""
        return self.variant, self.bm, self.bn


def _fit(M: int, rows: tuple[int, ...]) -> int:
    """The smallest tile height of ``rows`` that holds M, else the largest."""
    return next((r for r in rows if M <= r), rows[-1])


def choose_launch(lanes: int, M: int, N: int, K: int, dtype: str, aligned: bool) -> Launch:
    """The kernel launch for ``lanes`` products ``(M, K) @ (K, N)`` of
    ``dtype`` ("float32" or "bfloat16").  ``aligned``: every base pointer is
    on 16 bytes (:func:`vector_aligned`); with it, K and N in whole 16-byte
    vectors take cp.async copies, anything else masked element-wise loads.
    Plain Python, decides nothing about a card.  Raises ``ValueError`` where
    the grid would pass the launch limits."""
    vec_elems = VECTOR_BYTES // (4 if dtype == "float32" else 2)
    loader = "vec" if aligned and K % vec_elems == 0 and N % vec_elems == 0 else "elem"
    if dtype == "float32":
        bm, bn = _fit(M, F32_ROWS), F32_BN
        kc = -(-K // 4) * 4                  # the whole panel, in float4 steps
        stages = 1
        if (bm * (kc + 4) + kc * bn) * 4 > PANEL_MAX_SMEM:
            kc, stages = RING_KC, RING_STAGES
        smem = stages * (bm * (kc + 4) + kc * bn) * 4
        variant = "f32_panel" if stages == 1 else "f32_ring"
    elif dtype == "bfloat16":
        bm, bn, kc, stages = _fit(M, BF16_ROWS), BF16_BN, RING_KC, RING_STAGES
        smem = stages * (bm * (kc + 8) + kc * (bn + 8)) * 2
        variant = "bf16_ring"
    else:
        raise ValueError(f"stream_pack takes float32 or bfloat16, not {dtype}")
    grid = (-(-N // bn), -(-M // bm), lanes)
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"lanes {lanes}, M {M} or N {N} exceeds the launch grid {grid}")
    return Launch(f"{variant}/{loader}", bm, bn, kc, stages, grid, smem)


def vector_aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor's first element lies on a 16-byte boundary."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


def _library(device: torch.device) -> ctypes.CDLL:
    """The built library, its kernels allowed dynamic shared memory above
    48 KB on ``device``: once per device, before the first launch there
    (which precedes any capture: a packed schedule runs once before it is
    captured)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.stream_pack_init.argtypes = []
        lib.stream_pack_init.restype = ctypes.c_int
        lib.stream_pack_matmul.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.stream_pack_matmul.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.stream_pack_init()
        if err != 0:
            raise RuntimeError(f"stream_pack_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def check_blocks(M: int, N: int, K: int, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128) -> tuple[int, int, int]:
    """The TPU kernel's block contract: blocks clamp to the dimensions, and
    each dimension must divide its block.  Returns the clamped blocks."""
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M},{N},{K}) must divide blocks ({bm},{bn},{bk})")
    return bm, bn, bk


def launch_for(x: torch.Tensor, w: torch.Tensor) -> Launch:
    """The launch :func:`stream_pack_matmul` makes for ``x`` and ``w``."""
    lanes, M, K = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    return choose_launch(lanes, M, w.shape[2], K, dtype, vector_aligned(x, w))


def stream_pack_matmul(
    x: torch.Tensor,            # (lanes, M, K); lane stride 0 for a shared x
    w: torch.Tensor,            # (lanes, K, N)
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; raises on anything else,
    and on operands that need a gradient with grad enabled (the kernel's
    gradient is :class:`.ops.StreamPack`'s)."""
    global launches
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError("stream_pack_matmul has no gradient: differentiate through "
                         "ops.stream_pack")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x and w must be 3-d; got {tuple(x.shape)} and {tuple(w.shape)}")
    lanes, M, K = x.shape
    if w.shape[0] != lanes or w.shape[1] != K:
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    N = w.shape[2]
    check_blocks(M, N, K, block_m, block_n, block_k)
    for name, t in (("x", x), ("w", w)):
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: the kernel takes its local shard "
                            "(ops.stream_pack runs it through local_map)")
        if t.device.type != "cuda":
            raise ValueError(f"stream_pack kernel needs CUDA tensors; {name} is on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != x.dtype:
            raise ValueError(f"x and w must both be float32 or both bfloat16; {name} is {t.dtype}")
    if w.device != x.device:
        raise ValueError(f"x and w must share one device; w is on {w.device}")
    if min(lanes, M, N, K) < 1:
        raise ValueError(f"empty product: lanes {lanes}, M {M}, N {N}, K {K}")
    if (K > 1 and x.stride(2) != 1) or (M > 1 and x.stride(1) != K):
        raise ValueError(f"x's rows must be contiguous; strides {x.stride()}")
    x_lane_stride = 0 if lanes == 1 else x.stride(0)
    if x_lane_stride not in (0, M * K):
        raise ValueError(f"x's lane stride must be 0 (shared) or M*K; got {x_lane_stride}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    launch = launch_for(x, w)
    lib = _library(x.device)
    out = torch.empty((lanes, M, N), dtype=x.dtype, device=x.device)
    err = lib.stream_pack_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        lanes, M, N, K, x_lane_stride, launch.stages, int(launch.vec), launch.bm,
        launch.bn, launch.kc, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stream_pack launch failed: CUDA error {err} ({launch})")
    launches += 1
    return out
