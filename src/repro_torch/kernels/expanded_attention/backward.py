"""The gradient of expanded attention on Hopper: ctypes wrapper over
``csrc/expanded_attention_bwd.cu``.

Not a port of a TPU kernel: the JAX package differentiates its jnp
expanded form through XLA.  :func:`expanded_attention_bwd` takes what the
forward saved (the five inputs, the output, the rows' log-sum-exp, q_pos)
and the output's gradient, and returns ``(dq_nope, dq_rope, dk_nope,
dk_rope, dv)`` in the inputs' dtype and shapes.  One call launches the
library's four kernels on PyTorch's current stream (a pre-pass for ``D =
rowsum(dO * O)`` and the query tiles' key limits from q_pos; dK_nope, dV
and each head's share of dK_rope per key tile; dQ per query tile, two a
CTA at bf16; the heads' shares of dK_rope summed in head order), so a CUDA
graph captures them; ``launches`` counts the calls, as the forward's
wrapper does.  Its plain version is :func:`.ref.expanded_attention_bwd_ref`.

bf16 loads q_nope, q_rope, k_nope, k_rope, v and dO by TMA: like the
forward, the wrapper passes its inputs through :func:`.kernel.prepare`,
which copies a tensor the kernels cannot read in place (counted in
``kernel.layout_copies``).  :func:`choose_launch`, plain Python, gives the
grids, threads and dynamic shared memory; the library sizes its shared
memory from the same formulas and refuses any other.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from . import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "expanded_attention_bwd.cu"
ROWS = KEYS = 64                  # tiles (csrc BM, BN)
BOX_BYTES = kernel.BOX_BYTES
DKDV_STAGES, DQ_STAGES = 3, 3     # bf16 rings: (Q, dO) stages of dK/dV, (K, V) stages of dQ
THREADS = {"bfloat16": (256, 256), "float32": (256, 256)}   # (dK/dV, dQ) threads a CTA
DQ_TILES = {"bfloat16": 2, "float32": 1}   # query tiles a dQ CTA
LD_QK, LD_V, LD_P = 193, 129, 65  # float32 tiles' row lengths, a padding column each

launches = 0
_lib = None
_ready_devices: set[int] = set()
_STRIDES = ctypes.c_longlong * 34     # 3 a tensor, 2 for k_rope and its gradient


@dataclass(frozen=True)
class BwdLaunch:
    """One call of the library: the grids of the dK/dV kernel (batch x
    heads, key tiles) and of the dQ kernel (batch x heads, pairs of query
    tiles at bf16, query tiles at float32; bf16 launches each as one
    dimension of their product, the (batch, head) outermost),
    their threads and dynamic shared memory, and the workspace: ``D`` and
    the LSE's rows, 2 x query tiles int32 limits, and each head's float32
    share of dK_rope."""

    dtype: str
    dkdv_grid: tuple[int, int]
    dq_grid: tuple[int, int]
    dkdv_threads: int
    dq_threads: int
    dkdv_smem: int
    dq_smem: int
    part_numel: int


def dkdv_smem_bytes(dtype: str, query_tiles: int) -> int:
    """Dynamic shared memory of a dK/dV CTA.  bf16 (csrc
    ``dkdv_bf16_smem``): K (three 8 KB boxes) and V (two), ``DKDV_STAGES``
    stages of Q and dO, each stage's P^T (64 x 64 float32, handed from one
    warpgroup to the other), each stage's 64 LSE, D and positions, 1 + 2 *
    stages mbarriers, the list's count and a pad, then the list of query
    tiles (an int each).  float32 (``dkdv_f32_smem``): K, Q, V and dO
    tiles, P and dS, the rows' LSE, D and positions."""
    if dtype == "bfloat16":
        return ((1 + DKDV_STAGES) * 5 * BOX_BYTES + DKDV_STAGES * KEYS * ROWS * 4
                + 3 * DKDV_STAGES * ROWS * 4 + 8 * (1 + 2 * DKDV_STAGES) + 8 + 4 * query_tiles)
    return 4 * (2 * KEYS * LD_QK + 2 * KEYS * LD_V + 2 * ROWS * LD_P + 3 * ROWS)


def dq_smem_bytes(dtype: str) -> int:
    """Dynamic shared memory of a dQ CTA.  bf16 (csrc ``dq_bf16_smem``): Q
    and dO of each of two query tiles, ``DQ_STAGES`` stages of K and V, 1 +
    stages mbarriers and a count a stage.  float32 (``dq_f32_smem``): Q,
    dO, K and V tiles, dS, the rows' LSE, D and positions."""
    if dtype == "bfloat16":
        return (2 + DQ_STAGES) * 5 * BOX_BYTES + 8 * (1 + DQ_STAGES) + 4 * DQ_STAGES
    return 4 * (2 * ROWS * LD_QK + 2 * ROWS * LD_V + ROWS * LD_P + 3 * ROWS)


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, S: int, N: int, T: int, nope: int, rope: int, dv: int,
                  dtype: str) -> BwdLaunch:
    """The backward launch for these shapes, widths and ``dtype``.  Plain
    Python.  Raises ``ValueError`` where :func:`.kernel.choose_launch`
    does, on a grid past the launch limits, or where the dK/dV CTA's list
    of query tiles would not fit its shared memory."""
    kernel.choose_launch(B, S, N, T, nope, rope, dv, dtype)
    q_tiles, k_tiles = -(-S // ROWS), -(-T // KEYS)
    if max(q_tiles, k_tiles) > kernel.MAX_GRID_Y:
        raise ValueError(f"expanded_attention_bwd: S {S} or T {T} exceeds the launch grid")
    dkdv = dkdv_smem_bytes(dtype, q_tiles)
    if dkdv > kernel.MAX_SMEM:
        raise ValueError(f"expanded_attention_bwd: {q_tiles} query tiles take {dkdv} bytes of "
                         f"shared memory; a CTA has {kernel.MAX_SMEM}")
    dq_grid = (B * N, -(-q_tiles // DQ_TILES[dtype]))
    if dtype == "bfloat16" and B * N * max(k_tiles, dq_grid[1]) > kernel.MAX_GRID_X:
        raise ValueError(f"expanded_attention_bwd: {B * N} heads of {k_tiles} key tiles exceed "
                         f"the launch grid")
    return BwdLaunch(dtype, (B * N, k_tiles), dq_grid, *THREADS[dtype], dkdv,
                     dq_smem_bytes(dtype), B * N * T * rope)


def _kernel(device: torch.device):
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.expanded_attention_bwd_init.argtypes = []
        lib.expanded_attention_bwd_init.restype = ctypes.c_int
        lib.expanded_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
            + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        lib.expanded_attention_bwd.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.expanded_attention_bwd_init()
        if err != 0:
            raise RuntimeError(f"expanded_attention_bwd_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def expanded_attention_bwd(q_nope, q_rope, k_nope, k_rope, v, o, lse, do, q_pos, *, scale):
    """``(dq_nope, dq_rope, dk_nope, dk_rope, dv)``, fresh contiguous tensors
    of the inputs' shapes and dtype, from the backward kernels on CUDA
    tensors; an input the kernels cannot read in place is copied once
    (:func:`.kernel.prepare`).  Raises on anything else."""
    global launches
    scale = float(scale)
    kernel.check(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale)
    B, S, N, nope = q_nope.shape
    T, rope, dv = k_nope.shape[1], q_rope.shape[-1], v.shape[-1]
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, S, N, dv) or t.dtype != q_nope.dtype or t.device != q_nope.device:
            raise ValueError(f"expanded_attention_bwd: {name} must be ({B}, {S}, {N}, {dv}) "
                             f"{q_nope.dtype} on {q_nope.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (lse.dtype != torch.float32 or lse.shape != (B, N, S) or not lse.is_contiguous()
            or lse.device != q_nope.device):
        raise ValueError(f"expanded_attention_bwd: lse must be contiguous float32 ({B}, {N}, "
                         f"{S}) on q_nope's device; got {tuple(lse.shape)} {lse.dtype}")
    if kernel.takes_plain(q_nope):
        raise ValueError(f"expanded_attention_bwd needs CUDA tensors; q_nope is on "
                         f"{q_nope.device}")
    dtype = str(q_nope.dtype)[6:]
    launch = choose_launch(B, S, N, T, nope, rope, dv, dtype)
    q_nope, q_rope, k_nope, k_rope, v, o, do = kernel.prepare(q_nope, q_rope, k_nope, k_rope, v,
                                                              o, do)
    q_pos = kernel.positions(q_pos)
    dev = q_nope.device
    grads = [torch.empty(t.shape, dtype=t.dtype, device=dev)
             for t in (q_nope, q_rope, k_nope, k_rope, v)]
    D = torch.empty((B, N, S), dtype=torch.float32, device=dev)
    tiles = torch.empty((2 * -(-S // ROWS),), dtype=torch.int32, device=dev)
    part = torch.empty((launch.part_numel,), dtype=torch.float32, device=dev)
    widths = (nope, rope, nope, rope, dv, dv, dv, nope, rope, nope, rope, dv)
    tensors = (q_nope, q_rope, k_nope, k_rope, v, o, do, *grads)
    st = _STRIDES(*(s for t, w in zip(tensors, widths) for s in kernel.strides(t, w)))
    err = _kernel(dev).expanded_attention_bwd(
        *(t.data_ptr() for t in tensors[:7]), lse.data_ptr(), q_pos.data_ptr(), D.data_ptr(),
        tiles.data_ptr(), part.data_ptr(), *(g.data_ptr() for g in grads), st, q_pos.stride(0),
        int(q_nope.dtype == torch.bfloat16), B, S, N, T, nope, rope, dv, launch.dkdv_smem,
        launch.dq_smem, scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"expanded_attention_bwd launch failed: error {err} ({launch})")
    launches += 1
    return tuple(grads)
