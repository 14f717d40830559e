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
copied once, counted in ``layout_copies``.  The plans (:func:`choose_launch`,
and the backward's :func:`choose_backward`) are functions of the shape
alone, so replays repeat bit for bit.  ``launches`` counts the calls that
launched the kernel from Python or recorded it into a CUDA graph under
capture; no rows launch nothing and count nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import run_plain, takes_plain

from .ref import rms_norm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rms_norm.cu"
DTYPES = (torch.float32, torch.bfloat16)
VEC = 16                      # bytes a group: 8 bf16 or 4 float32 elements
WARP_MAX = 1024               # the widest row a warp takes forward; wider rows take a block
WARP_ROWS = 8                 # rows a block in the warp layout (csrc WARP_ROWS)
MAX_ROWS = 2**31 - 1          # the grid's x limit
# the backward (csrc's constants of the same names)
MAX_ITEMS = 4                 # 16-byte groups a thread holds in registers
TEAM_THREADS = 256            # the rows kernel's block at most: eight warps
WIDE_THREADS = 512            # rms_bwd_kernel_wide's block
MAX_CLUSTER = 8               # CTAs a cluster, the portable most
MAX_SMEM = 200 * 1024         # shared d(scale) rows a block, at most
MAX_WIDTH = MAX_SMEM // 4     # the widest row: rms_bwd_kernel_wide's float32 row in shared memory
# the card the grid is sized to: an H100 SXM's SMs, and what each holds
SMS = 132
SM_THREADS = 2048
SM_REGISTERS = 65536
SM_SMEM = 228 * 1024          # shared memory an SM; each block also reserves 1 KB
SM_BLOCKS = 32
# registers a thread of each backward rows kernel takes, by (the kernel:
# "warp" rms_bwd_kernel, "tma" or "wide"; vector loads; bytes an element),
# one count an item (the wide kernel's for items 0): ptxas's counts
# (chip_smoke's phase 3e prints them, and fails when the residency they
# give differs from the card's occupancy for a plan)
REGISTERS = {("warp", True, 2): (64, 102, 128, 165), ("warp", False, 2): (120, 158, 173, 212),
             ("warp", True, 4): (64, 80, 102, 121), ("warp", False, 4): (78, 102, 122, 157),
             ("tma", True, 2): (60, 80, 125, 128), ("tma", True, 4): (48, 64, 80, 100),
             ("wide", True, 2): (50,), ("wide", False, 2): (50,), ("wide", True, 4): (52,),
             ("wide", False, 4): (52,)}
ROWS_AHEAD = 2                # rms_bwd_kernel and _wide: rows a team takes at least, where the
                              # rows allow (the next row's loads go out under the current row's sum)
# rms_bwd_kernel_tma (tools/rms_bwd_variants.py --sweep chose these on the
# card at 19c's and 19h's rows): rows of x and dy in flight a block, groups a
# thread where eight warps hold the row so, and the threads an SM runs
STAGES = 2
RING_ITEMS = 3
RING_THREADS_SM = 256
# the SMs whose blocks whole clusters of each size fill at once on an H100
# SXM (cudaOccupancyMaxActiveClusters: 15 clusters of 8 and 30 of 4 at a
# block an SM, 66 of 2)
CLUSTER_SMS = {1: 132, 2: 132, 4: 120, 8: 120}
# the smallest cluster whose partial rows, written and read, stay within this
# share of the bytes the bound counts (else the largest the grid allows).  A
# cluster's syncs cost more than the rows they save: at 19c's rows clusters
# of 2 (17% of the bound's bytes) beat clusters of 4 (8.6%) on the card
# (tools/rms_bwd_variants.py)
PART_SHARE = 1 / 5

# the constants the library and the wrapper must agree on (rms_<name>() in csrc)
CONSTANTS = ("WARP_ROWS", "MAX_SMEM", "MAX_ITEMS", "MAX_CLUSTER", "TEAM_THREADS", "WIDE_THREADS")

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
    """The forward's plan: ``warp`` (a warp a row, :data:`WARP_ROWS` rows a
    block) or a block a row; ``threads`` a block; ``grid`` blocks."""

    warp: bool
    threads: int
    grid: int


@functools.lru_cache(maxsize=1024)
def choose_launch(rows: int, width: int) -> Launch:
    """The forward's plan for ``rows`` rows of ``width`` elements: a warp a
    row up to :data:`WARP_MAX`, else a block a row of 64 to 512 threads,
    about three 16-byte groups of bf16 a thread.  Plain Python, a function
    of the shape alone."""
    _check_shape(rows, width)
    if width <= WARP_MAX:
        return Launch(warp=True, threads=32 * WARP_ROWS, grid=-(-rows // WARP_ROWS))
    groups = -(-width // 8)
    threads = 64 if groups <= 192 else 128 if groups <= 384 else 256 if groups <= 768 else 512
    return Launch(warp=False, threads=threads, grid=rows)


@dataclass(frozen=True)
class BwdLaunch:
    """The backward's plan.  ``items``: the 16-byte groups each thread of a
    row holds in registers (0: rms_bwd_kernel_wide, the row's d(scale) sums
    in shared memory).  ``stages``: rows of x and dy in flight in
    rms_bwd_kernel_tma's shared ring, a block a row (0 with items:
    rms_bwd_kernel, a warp a row, ``threads // 32`` rows a block).
    ``grid`` blocks in clusters of ``cluster``; ``smem`` bytes of shared
    memory a block (the ring and its barriers, a d(scale) row a team)."""

    items: int
    stages: int
    threads: int
    grid: int
    cluster: int
    smem: int

    @property
    def warp(self) -> bool:
        """A warp a row (rms_bwd_kernel)."""
        return self.items > 0 and not self.stages

    @property
    def kind(self) -> str:
        """The rows kernel: "warp" (rms_bwd_kernel), "tma" or "wide"."""
        return "warp" if self.warp else "tma" if self.stages else "wide"

    @property
    def teams(self) -> int:
        """Rows a block takes at once."""
        return self.threads // 32 if self.warp else 1

    @property
    def parts(self) -> int:
        """Partial d(scale) rows: one a cluster."""
        return self.grid // self.cluster


def _check_shape(rows: int, width: int) -> None:
    if rows < 0 or width < 1:
        raise ValueError(f"rms_norm: {rows} rows x {width} elements")
    if rows > MAX_ROWS:
        raise ValueError(f"rms_norm: {rows} rows, more than the grid's {MAX_ROWS}")
    if width > MAX_WIDTH:
        raise ValueError(f"rms_norm: rows of {width} elements; the backward takes at most "
                         f"{MAX_WIDTH}")


def bwd_smem(width: int, elem_bytes: int, teams: int, stages: int) -> int:
    """Shared memory a backward block takes: a float32 d(scale) row a team
    and, with a ring, each team's ``stages`` rows of x and dy and their
    barriers (8 bytes each)."""
    return teams * (stages * (2 * width * elem_bytes + 8) + 4 * width)


def blocks_an_sm(plan: BwdLaunch, elem_bytes: int, vec: bool = True) -> int:
    """The rows kernel's blocks an H100 SM holds at once under ``plan``:
    the least of its threads', registers' (:data:`REGISTERS`, in units of
    8 a thread), shared memory's and blocks' limits."""
    regs = REGISTERS[plan.kind, vec or plan.kind == "tma", elem_bytes][max(plan.items, 1) - 1]
    regs = -(-regs // 8) * 8
    return max(1, min(SM_BLOCKS, SM_THREADS // plan.threads,
                      SM_REGISTERS // (plan.threads * regs),
                      SM_SMEM // (plan.smem + 256 + 1024)))


@functools.lru_cache(maxsize=1024)
def choose_backward(rows: int, width: int, elem_bytes: int, vec: bool = True) -> BwdLaunch:
    """The backward's plan for ``rows`` rows of ``width`` elements of
    ``elem_bytes`` (2: bf16, 4: float32), ``vec`` when every row lies on 16
    bytes (:func:`aligned`).  A row whose whole 16-byte groups 32 threads
    hold, at most :data:`MAX_ITEMS` a thread, takes a warp (eight warps a
    block, loads into registers).  A wider aligned row takes a block of up
    to eight warps through a shared ring of :data:`STAGES` rows,
    :data:`RING_ITEMS` groups a thread where eight warps hold the row so,
    as many blocks an SM as make about :data:`RING_THREADS_SM` threads.
    Other rows (wider than eight warps hold, or a block row not on 16
    bytes) take rms_bwd_kernel_wide.  The grid is what the card holds at
    once (:func:`blocks_an_sm` on :data:`SMS` SMs), no more than the rows
    give (each ring block a row, each other team :data:`ROWS_AHEAD`), in the
    smallest clusters whose partial rows keep within :data:`PART_SHARE` of
    the bound's bytes, and no more whole clusters than the card holds at
    once (:data:`CLUSTER_SMS`).  Plain Python, a function of the shape
    alone."""
    _check_shape(rows, width)
    if elem_bytes not in (2, 4):
        raise ValueError(f"rms_norm: {elem_bytes} bytes an element; B8 takes 2 or 4")
    whole = width // (VEC // elem_bytes)
    stages = 0
    if whole <= 32 * MAX_ITEMS:
        items, threads = max(1, -(-whole // 32)), 32 * WARP_ROWS
    elif vec and whole <= TEAM_THREADS * MAX_ITEMS:
        most = RING_ITEMS if whole <= TEAM_THREADS * RING_ITEMS else MAX_ITEMS
        warps = -(-whole // (32 * most))   # the widest ring, 8192 bf16, takes 96 KB
        items, threads, stages = -(-whole // (32 * warps)), 32 * warps, STAGES
    else:
        items, threads = 0, WIDE_THREADS
    teams = threads // 32 if items and not stages else 1
    plan = BwdLaunch(items=items, stages=stages, threads=threads, grid=1, cluster=1,
                     smem=bwd_smem(width, elem_bytes, teams, stages))
    resident = blocks_an_sm(plan, elem_bytes, vec)
    per_sm = min(resident, max(1, round(RING_THREADS_SM / threads))) if stages else resident
    grid = min(SMS * per_sm,
               -(-max(rows, 1) // (plan.teams * (1 if stages else ROWS_AHEAD))))
    if items == 0:
        return dataclasses.replace(plan, grid=grid)
    bound_bytes = rows * width * elem_bytes * 3 + rows * 4 + width * 8
    fits = [c for c in (1, 2, 4, 8) if c <= min(grid, MAX_CLUSTER)]
    cluster = next((c for c in fits if grid // c * width * 8 <= PART_SHARE * bound_bytes),
                   fits[-1])
    grid = min(grid, CLUSTER_SMS[cluster] * resident // cluster * cluster)
    return dataclasses.replace(plan, grid=grid // cluster * cluster, cluster=cluster)


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
        for name in ("rms_init", *(f"rms_{c.lower()}" for c in CONSTANTS)):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.rms_forward.argtypes = [_P, _LL, _LL, _LL, _P, _F, _F, _I, _I, _I, _I, _LL, _P, _P, _P]
        lib.rms_forward.restype = _I
        lib.rms_backward.argtypes = [_P, _LL, _P, _LL, _P, _LL, _LL, _P, _F, *[_I] * 8, _P, _P, _P,
                                     _P]
        lib.rms_backward.restype = _I
        lib.rms_bwd_occupancy.argtypes = [*[_I] * 7, ctypes.POINTER(_I)]
        lib.rms_bwd_occupancy.restype = _I
        got = {name: getattr(lib, f"rms_{name.lower()}")() for name in CONSTANTS}
        want = {name: globals()[name] for name in CONSTANTS}
        if got != want:
            raise RuntimeError(f"rms_norm: the library's constants {got}; the wrapper plans "
                               f"for {want}")
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
