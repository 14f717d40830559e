"""Hopper RMSNorm (B8), the forward: ctypes wrapper over
``csrc/rms_norm.cu``.

Every RMSNorm of the port's models: ``layers.apply_norm``'s rmsnorm branch
(``offset`` 1.0) and ``_rms(x) * scale`` (``offset`` 0.0: the qk-norm and
MLA's ``kv_norm``).  XLA's fusion of those chains inside the JAX package's
jitted step, not a TPU kernel.  :func:`rms_norm` is one kernel launch:
each row of x read, y written in x's dtype, and each row's float32 rstd
saved for the backward (:mod:`.backward`).  The plain version is
:func:`.ref.rms_norm_ref`.

Routing.  CPU and meta tensors take the plain version through
:func:`repro_torch.kernels.run_plain` (the dry run counts it as one
launch); CUDA tensors launch the kernel or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`): :mod:`.ops` runs
the local shards.  The checks are plain Python and run before the
routing: x float32 or bfloat16 ``(..., width)``, scale float32
``(width,)`` on x's device, ``offset`` 0.0 or 1.0.

Layout.  The rows are read where they lie when x's leading dimensions
fold into one row stride with the last dimension contiguous (MLA's
``c_kv``, 512 wide in 576-wide rows, is such a view); anything else is
copied once, counted in ``layout_copies``.  The plan
(:func:`choose_launch`) is a function of the shape alone, so replays
repeat bit for bit.  ``launches`` counts the calls that launched the
kernel from Python or recorded it into a CUDA graph under capture; no
rows launch nothing and count nothing.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import run_plain, takes_plain

from .ref import rms_norm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rms_norm.cu"
DTYPES = (torch.float32, torch.bfloat16)
VEC = 16                      # bytes a group: 8 bf16 or 4 float32 elements
WARP_MAX = 1024               # the widest row a warp takes; wider rows take a block
WARP_ROWS = 8                 # rows a block in the warp layout (csrc WARP_ROWS)
BWD_BLOCKS = 264              # the backward's persistent grid, at most: 2 a Hopper SM
MAX_SMEM = 200 * 1024         # the backward's accumulators, at most (csrc MAX_SMEM)
MAX_WIDTH = MAX_SMEM // 4     # a row's float32 accumulators fit one block's shared memory
MAX_ROWS = 2**31 - 1          # the grid's x limit

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


@dataclass(frozen=True)
class Launch:
    """One call's plan: ``warp`` (a warp a row, :data:`WARP_ROWS` rows a
    block) or a block a row; ``threads`` a block; ``grid`` blocks (the
    backward's at most :data:`BWD_BLOCKS`, each walking its rows)."""

    warp: bool
    threads: int
    grid: int


@functools.lru_cache(maxsize=1024)
def choose_launch(rows: int, width: int, backward: bool = False) -> Launch:
    """The plan for ``rows`` rows of ``width`` elements: a warp a row up to
    :data:`WARP_MAX`, else a block a row of 64 to 512 threads, about three
    16-byte groups of bf16 a thread.  Plain Python, a function of the shape
    alone."""
    if rows < 0 or width < 1:
        raise ValueError(f"rms_norm: {rows} rows x {width} elements")
    if rows > MAX_ROWS:
        raise ValueError(f"rms_norm: {rows} rows, more than the grid's {MAX_ROWS}")
    if width > MAX_WIDTH:
        raise ValueError(f"rms_norm: rows of {width} elements; the backward's accumulators "
                         f"take at most {MAX_WIDTH}")
    if width <= WARP_MAX:
        warp, threads, items = True, 32 * WARP_ROWS, -(-rows // WARP_ROWS)
    else:
        groups = -(-width // 8)
        threads = 64 if groups <= 192 else 128 if groups <= 384 else 256 if groups <= 768 else 512
        warp, items = False, rows
    return Launch(warp=warp, threads=threads,
                  grid=min(items, BWD_BLOCKS) if backward else items)


def rows_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``(rows, width)`` read in place: a view when its leading
    dimensions fold into one row stride and its last is contiguous, else
    one contiguous copy, counted in ``layout_copies``."""
    global layout_copies
    width = t.shape[-1]
    if t.stride(-1) == 1 or width == 1:
        try:
            return t.view(-1, width)
        except RuntimeError:
            pass
    layout_copies += 1
    return t.contiguous().view(-1, width)


def aligned(*rows: torch.Tensor) -> int:
    """Every row of every ``(rows, width)`` operand starts on 16 bytes and
    holds whole groups: the kernel reads and writes them as vectors."""
    return int(all(r.data_ptr() % VEC == 0 and (r.shape[-1] * r.element_size()) % VEC == 0
                   and (r.stride(0) * r.element_size()) % VEC == 0 for r in rows))


def check(x, scale, offset: float) -> None:
    for what, t in (("x", x), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rms_norm: {what} is {type(t).__name__}, not a tensor")
        takes_plain(t)
    if x.dtype not in DTYPES:
        raise ValueError(f"rms_norm: x is {x.dtype}; B8 takes {DTYPES}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"rms_norm: x {tuple(x.shape)} has no row")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rms_norm: scale must be float32 ({x.shape[-1]},); got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"rms_norm: scale on {scale.device}, x on {x.device}")
    if offset not in (0.0, 1.0):
        raise ValueError(f"rms_norm: offset {offset}; B8 takes 0.0 or 1.0")


def library(device: torch.device):
    """The library, loaded once, its kernels loaded on ``device`` once (a
    CUDA graph capture then never loads one)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        for name in ("rms_init", "rms_warp_rows", "rms_max_smem"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.rms_forward.argtypes = [_P, _LL, _LL, _LL, _P, _F, _F, _I, _I, _I, _I, _LL, _P, _P, _P]
        lib.rms_forward.restype = _I
        lib.rms_backward.argtypes = [_P, _LL, _P, _LL, _P, _LL, _LL, _P, _F, _I, _I, _I, _I, _LL,
                                     _P, _P, _P, _P]
        lib.rms_backward.restype = _I
        if (lib.rms_warp_rows(), lib.rms_max_smem()) != (WARP_ROWS, MAX_SMEM):
            raise RuntimeError(f"rms_norm: the library has {lib.rms_warp_rows()} rows a warp "
                               f"block and {lib.rms_max_smem()} bytes of accumulators; the "
                               f"wrapper plans for {WARP_ROWS} and {MAX_SMEM}")
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            raise_on(_lib.rms_init(), "rms_init")
        _ready_devices.add(index)
    return _lib


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: ``y = (x * rstd * (offset + scale)).to(x.dtype)`` of
    x's shape (contiguous), ``rstd = rsqrt(mean(x^2) + eps)`` float32 of
    its leading shape."""
    global launches
    check(x, scale, offset)
    lead, width = x.shape[:-1], x.shape[-1]
    if takes_plain(x):
        with torch.no_grad():
            return run_plain(functools.partial(rms_norm_ref, eps=eps, offset=offset), x, scale)
    xr = rows_of(x)
    rows = xr.shape[0]
    y = torch.empty(rows, width, dtype=x.dtype, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        plan = choose_launch(rows, width)
        w = scale.contiguous()
        err = library(x.device).rms_forward(
            xr.data_ptr(), xr.stride(0), rows, width, w.data_ptr(), offset, eps,
            int(x.dtype == torch.bfloat16), aligned(xr, y), int(plan.warp), plan.threads,
            plan.grid, y.data_ptr(), rstd.data_ptr(), stream(x.device))
        raise_on(err, "rms_forward")
        launches += 1
    return y.view(x.shape), rstd.view(lead)
