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
reads once per block and never copies.  Each operand's matrices lie
row-major or transposed (``x.transpose(1, 2)`` of a contiguous
``(lanes, K, M)``, ``w.transpose(1, 2)`` of a contiguous ``(lanes, N, K)``):
:func:`operand_layout` reads which from the strides and the kernel reads
the operand where it lies, so a gradient's ``wᵀ`` and ``xᵀ`` are views.
Any other layout is copied once by :func:`operands` and counted in
``layout_copies``.  The library is built with ``nvcc``
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
# The bf16 weight stream (bf16_tma): persistent blocks, one an SM of the
# H100 SXM's 132, walk (lane, row tile, column tile) items; a producer
# warp feeds a ring of TMA_KC-deep stages (a row tile of x and a column
# tile of w) to four consumer warps of 64 columns each.  Two stages were
# measured as fast as five (tools/stream_pack_variants.py, PERF.md).
SMS = 132
TMA_ROWS = (16, 32, 64)      # row tiles, fitted to M; 64 where x lies transposed
TMA_BN = 256                 # column tile: 512 contiguous bytes of a weight row
TMA_KC = 64                  # one 128-byte swizzle row of bf16
TMA_STAGES = 2
# the stream is chosen where one lane's weight panel (K x N), or its
# output panel where x lies transposed (dw = xᵀ · dy), holds at least
# this many bytes.  Measured over 64 lanes of K = N panels
# (tools/stream_pack_variants.py --sweep, PERF.md): the stream 1.1-1.4x the
# 32-column ring at 128 KB, 2.3-2.5x at 512 KB, 1.2-1.9x from 1.2 MB up;
# smaller bf16 products keep the ring
TMA_MIN_PANEL = 512 << 10
# (x, w) layouts: n row-major, t transposed; the stream and the wgmma
# kernel read the first three, the rings' element-wise loads all four
LAYOUTS = ("nn", "nt", "tn", "tt")
TMA_LAYOUTS = LAYOUTS[:3]
# Training's products (bf16_wgmma): the stream's conditions (bf16, a
# per-lane x, TMA's alignment, a panel of TMA_MIN_PANEL) at M past the
# stream's 64 rows for nn and nt, or, for tn (dw = xᵀ · dy, whose depth is
# the tokens a lane holds), at a depth of WGMMA_MIN_DEPTH.  Persistent
# blocks, one an SM, walk 128 x 256 output tiles on wgmma m64n256k16 (two
# warpgroups of 64 rows), fed by a ring of WGMMA_STAGES TMA stages 64 deep
# (csrc/stream_pack.cu, 3.): 4 stages of 48 KB beside a 32 KB staging tile,
# which the warpgroups take in turns, fill 230,464 of the 232,448 bytes a
# block may have.
# The blocks go in clusters of the first of WGMMA_CLUSTERS that divides the
# row tiles, along M: a cluster's blocks take one column tile of as many
# row tiles, and each loads a share of w's tile for all of them (TMA
# multicast).  WGMMA_MIN_DEPTH: tools/stream_pack_variants.py --train
# (PERF.md) timed DeepSeek-V2's dw at depths 64, 96, 128, 160, 256 and 384:
# the stream took 1.07 ms at 64 and 1.48 at 96, the wgmma kernel 1.09-1.11
# and 1.17-1.18; M > 64 is where nn and nt turn too (at M 96 the wgmma
# kernel 0.94-1.02 ms, the stream 1.02-1.17; at 64 the stream 0.87-0.89,
# the wgmma kernel 0.91-0.96).
WGMMA_BM, WGMMA_BN, WGMMA_KC = 128, 256, 64
WGMMA_STAGES = 4
WGMMA_CLUSTERS = (2, 3, 1)
WGMMA_MIN_DEPTH = 96
# every kernel of the library as (variant, bm, bn): csrc/stream_pack.cu
# instantiates the same tiles (kInstances, kTma, kWgmma), and phase 6 of
# chip_smoke.py launches each of them
INSTANCES = tuple(
    (f"{kind}/{loader}", bm, bn)
    for kind, rows, bn in (("f32_panel", F32_ROWS, F32_BN), ("f32_ring", F32_ROWS, F32_BN),
                           ("bf16_ring", BF16_ROWS, BF16_BN))
    for bm in rows for loader in ("vec", "elem")) + tuple(
    (f"bf16_tma/{lay}", rt, TMA_BN)
    for lay in TMA_LAYOUTS for rt in (TMA_ROWS if lay[0] == "n" else TMA_ROWS[-1:])) + tuple(
    (f"bf16_wgmma/{lay}", WGMMA_BM, WGMMA_BN) for lay in TMA_LAYOUTS)
_KIND = {"f32_panel": 0, "f32_ring": 0, "bf16_ring": 1, "bf16_tma": 2, "bf16_wgmma": 3}

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()
_STRIDES = ctypes.c_longlong * 6      # x: lane, row, depth; w: lane, depth, column


@dataclass(frozen=True)
class Launch:
    """One launch of the library: ``variant`` names the kernel and its loader
    (``"f32_panel/vec"``: cp.async 16-byte copies; ``"/elem"``: masked
    element-wise loads, any layout; ``"bf16_tma/nt"``: the TMA weight
    stream, x row-major and w transposed), ``bm x bn`` the output tile,
    ``kc`` the K depth of one shared-memory stage and ``stages`` their
    number (1: the whole K panel in one load).  ``layout`` is x's and w's:
    ``n`` row-major, ``t`` transposed.  The library sizes the grid and the
    shared memory from the tile itself; ``grid`` and ``smem_bytes`` here
    are the same numbers, for the launch-limit check and for display (the
    stream's grid is its persistent blocks; the wgmma kernel's the most it
    launches, in clusters of ``cluster`` blocks, fewer where the card holds
    fewer such clusters at once)."""

    variant: str
    bm: int
    bn: int
    kc: int
    stages: int
    grid: tuple[int, int, int]
    smem_bytes: int
    layout: str = "nn"
    cluster: int = 1

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


def tma_smem_bytes(rt: int, stages: int) -> int:
    """The stream's dynamic shared memory, as the library sizes it: 1024
    bytes to align the ring, ``stages`` stages of an ``rt``-row x tile and
    a ``TMA_BN``-column w tile (128 bytes a row of either), each of the
    four consumer warps' 16 staged output rows (64 columns padded by 16
    bytes), and the ring's mbarriers."""
    return 1024 + stages * (rt + TMA_BN) * 128 + 4 * 16 * 72 * 2 + 16 * stages


def wgmma_smem_bytes(stages: int) -> int:
    """The wgmma kernel's dynamic shared memory, as the library sizes it:
    1024 bytes to align the ring, ``stages`` stages of x's 128 rows and w's
    256 columns (128 bytes a row of either), one warpgroup's 64 x 256 bf16
    outputs staged (the warpgroups take turns), and the ring's mbarriers."""
    return 1024 + stages * (WGMMA_BM + WGMMA_BN) * 128 + WGMMA_BM * WGMMA_BN + 16 * stages


def _tma_launch(lanes: int, M: int, N: int, rt: int, layout: str) -> Launch:
    """The stream's launch: one persistent block an SM (fewer where there
    are fewer items), a ring of ``TMA_STAGES``."""
    items = lanes * -(-M // rt) * -(-N // TMA_BN)
    if items > MAX_GRID_X:
        raise ValueError(f"lanes {lanes}, M {M} or N {N} exceeds the stream's {MAX_GRID_X} items")
    return Launch(f"bf16_tma/{layout}", rt, TMA_BN, TMA_KC, TMA_STAGES, (min(items, SMS), 1, 1),
                  tma_smem_bytes(rt, TMA_STAGES), layout)


def _wgmma_launch(lanes: int, M: int, N: int, layout: str) -> Launch:
    """Training's products: persistent blocks, one an SM (fewer where there
    are fewer items), in clusters along M, over 128 x 256 tiles, a ring of
    ``WGMMA_STAGES``."""
    row_tiles = -(-M // WGMMA_BM)
    cluster = next(c for c in WGMMA_CLUSTERS if row_tiles % c == 0)
    items = lanes * row_tiles // cluster * -(-N // WGMMA_BN)
    if items > MAX_GRID_X:
        raise ValueError(f"lanes {lanes}, M {M} or N {N} exceeds the wgmma kernel's "
                         f"{MAX_GRID_X} items")
    return Launch(f"bf16_wgmma/{layout}", WGMMA_BM, WGMMA_BN, WGMMA_KC, WGMMA_STAGES,
                  (min(items, SMS // cluster) * cluster, 1, 1), wgmma_smem_bytes(WGMMA_STAGES),
                  layout, cluster)


def choose_launch(lanes: int, M: int, N: int, K: int, dtype: str, aligned: bool, *,
                  x_t: bool = False, w_t: bool = False, shared: bool = False) -> Launch:
    """The kernel launch for ``lanes`` products ``(M, K) @ (K, N)`` of
    ``dtype`` ("float32" or "bfloat16").  ``aligned``: every base pointer is
    on 16 bytes (:func:`vector_aligned`); ``x_t``/``w_t``: x/w lies
    transposed; ``shared``: one x for every lane (lane stride 0).  bf16
    products with a per-lane x, TMA's alignment (16-byte bases and rows)
    and a weight panel of at least ``TMA_MIN_PANEL`` bytes take the wgmma
    kernel at M > 64 with x row-major, or from a depth K of
    ``WGMMA_MIN_DEPTH`` where x lies transposed; else the TMA weight stream
    at M <= 64, or wherever x lies transposed (its output panel counted).
    Everything else takes the rings: row-major operands with K and N in
    whole 16-byte vectors take cp.async copies, anything else masked
    element-wise loads.  Plain Python, decides nothing about a card.
    Raises ``ValueError`` where the grid would pass the launch limits."""
    layout = ("t" if x_t else "n") + ("t" if w_t else "n")
    vec_elems = VECTOR_BYTES // (4 if dtype == "float32" else 2)
    # the rows of x, w and out as they lie (M for xᵀ, K for x and wᵀ, N for
    # w and out) in whole 16-byte units
    rows_ok = (M if x_t else K) % 8 == 0 and (K if w_t else N) % 8 == 0 and N % 8 == 0
    if dtype == "bfloat16" and layout in TMA_LAYOUTS and aligned and not shared and rows_ok \
            and max(K, M if x_t else 0) * N * 2 >= TMA_MIN_PANEL:
        if (K >= WGMMA_MIN_DEPTH) if x_t else (M > TMA_ROWS[-1]):
            return _wgmma_launch(lanes, M, N, layout)
        if M <= TMA_ROWS[-1] or x_t:
            return _tma_launch(lanes, M, N, TMA_ROWS[-1] if x_t else _fit(M, TMA_ROWS), layout)
    loader = "vec" if (aligned and layout == "nn" and K % vec_elems == 0
                       and N % vec_elems == 0) else "elem"
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
    return Launch(f"{variant}/{loader}", bm, bn, kc, stages, grid, smem, layout)


def vector_aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor's first element lies on a 16-byte boundary."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


def operand_layout(t: torch.Tensor, shared_ok: bool = False) -> str | None:
    """How each lane's matrix of the 3-d operand ``t`` lies: ``"n"``
    row-major, ``"t"`` the transpose of a row-major matrix (its rows
    contiguous), None for any other layout.  Lanes follow one another
    densely, or all lie at one place (lane stride 0) where ``shared_ok``.
    Read from the strides alone."""
    lanes, R, C = t.shape
    s0, s1, s2 = t.stride()
    if (C == 1 or s2 == 1) and (R == 1 or s1 == C):
        layout = "n"
    elif (R == 1 or s1 == 1) and (C == 1 or s2 == R):
        layout = "t"
    else:
        return None
    if lanes == 1 or s0 == R * C or (shared_ok and s0 == 0):
        return layout
    return None


def operands(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` and ``w`` as the kernel reads them: each where it lies when
    :func:`operand_layout` names its layout, else one contiguous copy,
    counted in ``layout_copies`` (a shared x copies its one matrix)."""
    global layout_copies
    if operand_layout(x, shared_ok=True) is None:
        layout_copies += 1
        x = (x[0].contiguous().expand_as(x) if x.shape[0] > 1 and x.stride(0) == 0
             else x.contiguous())
    if operand_layout(w) is None:
        layout_copies += 1
        w = w.contiguous()
    return x, w


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
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.stream_pack_matmul.restype = ctypes.c_int
        lib.stream_pack_wgmma_clusters.argtypes = [ctypes.c_int] * 4
        lib.stream_pack_wgmma_clusters.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.stream_pack_init()
        if err != 0:
            raise RuntimeError(f"stream_pack_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def resident_clusters(launch: Launch, device: torch.device) -> int:
    """How many of a wgmma launch's clusters the card holds at once: the
    library launches ``min(launch.grid[0] / launch.cluster, this)``
    clusters (0 where the card cannot say)."""
    return _library(device).stream_pack_wgmma_clusters(
        int(launch.layout[0] == "t"), int(launch.layout[1] == "t"), launch.stages, launch.cluster)


def check_blocks(M: int, N: int, K: int, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128) -> tuple[int, int, int]:
    """The TPU kernel's block contract: blocks clamp to the dimensions, and
    each dimension must divide its block.  Returns the clamped blocks."""
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M},{N},{K}) must divide blocks ({bm},{bn},{bk})")
    return bm, bn, bk


def launch_for(x: torch.Tensor, w: torch.Tensor) -> Launch:
    """The launch :func:`stream_pack_matmul` makes for ``x`` and ``w``, their
    layouts read from the strides.  Raises ``ValueError`` on a layout the
    kernel does not read."""
    lanes, M, K = x.shape
    x_layout, w_layout = operand_layout(x, shared_ok=True), operand_layout(w)
    if x_layout is None or w_layout is None:
        raise ValueError(f"stream_pack reads each lane's matrix row-major or transposed, lanes "
                         f"dense (x also shared): x strides {x.stride()}, w strides {w.stride()}")
    dtype = str(x.dtype).removeprefix("torch.")
    return choose_launch(lanes, M, w.shape[2], K, dtype, vector_aligned(x, w),
                         x_t=x_layout == "t", w_t=w_layout == "t",
                         shared=lanes > 1 and x.stride(0) == 0)


def _strides(x: torch.Tensor, w: torch.Tensor, layout: str) -> _STRIDES:
    """x's (lane, row, depth) and w's (lane, depth, column) strides in
    elements, as the layout lays them (a size-1 dimension's stride is
    whatever PyTorch left, so it is not read)."""
    lanes, M, K = x.shape
    N = w.shape[2]
    x_lane = 0 if lanes == 1 else x.stride(0)
    xs = (K, 1) if layout[0] == "n" else (1, M)
    ws = (N, 1) if layout[1] == "n" else (1, K)
    return _STRIDES(x_lane, *xs, K * N, *ws)


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
    launch = launch_for(x, w)
    lib = _library(x.device)
    out = torch.empty((lanes, M, N), dtype=x.dtype, device=x.device)
    err = lib.stream_pack_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        lanes, M, N, K, _strides(x, w, launch.layout), _KIND[launch.variant.split("/")[0]],
        launch.stages, int(launch.vec), launch.bm, launch.bn, launch.kc,
        int(launch.layout[0] == "t"), int(launch.layout[1] == "t"), launch.cluster,
        launch.grid[0], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stream_pack launch failed: CUDA error {err} ({launch})")
    launches += 1
    return out
