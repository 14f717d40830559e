"""Hopper flash attention: ctypes wrapper over ``csrc/flash_attention.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
(``repro/kernels/flash_attention/kernel.py::flash_attention``), with the
same signature minus the TPU's block sizes and interpret mode.  The kernel
masks the ragged edge, so any ``Sq`` and ``Skv`` are accepted.  The library
is built with ``nvcc`` for ``sm_90a`` at first launch (see
:mod:`repro_torch.kernels.build`); the kernel launches on PyTorch's current
stream, so it is captured by a CUDA graph like any other operator.

Both kernels read the model layout ``(B, S, heads, head_dim)`` through
strides (:func:`attention`); :func:`flash_attention` passes the JAX-style
``(BH, S, head_dim)`` layout as ``B = 1`` with ``BH`` heads.  The bf16
kernel loads its tiles by TMA, whose tensor maps need 16-byte aligned base
pointers and strides: a tensor that misses them, or whose last dimension
is not contiguous, is copied once here and counted in ``layout_copies``.
:func:`choose_launch`, plain Python, picks the bf16 tile (one consumer
warpgroup per 64-row query tile, or two that split its K/V tiles) and
reports the grid, shared memory and TMA boxes; the library sizes its
shared memory from the same formula (:func:`smem_bytes`).

Gradients.  :func:`attention` and :func:`flash_attention` on inputs that
need a gradient, with grad enabled, go through
:class:`.ops.FlashAttention`, whose forward is this kernel writing each
row's log-sum-exp too (:func:`attend` with ``with_lse=True``) and whose
backward is the backward kernel (:mod:`.backward`); otherwise they launch
the forward alone, as serving does.

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture (which does not run it).  A
CUDA-graph replay runs it again without passing through here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 80, 128)
SMS = 132                     # an H100 SXM's streaming multiprocessors
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535
STAGES = 3                    # the bf16 K/V ring (csrc STAGES)
# the bf16 tiles as (consumer warpgroups, keys per K/V tile) of a 64-row
# query tile: one warpgroup takes every K/V tile, or two split them (even
# and odd) and merge; csrc/flash_attention.cu instantiates both for every
# head dim (launch_bf16_tile)
TILES = ((1, 64), (2, 64))
ROWS = 64
F32_ROWS, F32_KEYS, F32_THREADS = 64, 64, 256
TMA_ALIGN = 16                # bytes: tensor-map base pointers and strides
TMA_MAX_STRIDE = 2**40        # bytes
# every kernel of the library as (dtype, head_dim, consumer warpgroups,
# keys per tile), 0 warpgroups for float32; phase 3 of chip_smoke.py
# launches each of them
INSTANCES = tuple(
    ("bfloat16", hd, nwg, bkv) for hd in HEAD_DIMS for nwg, bkv in TILES
) + tuple(("float32", hd, 0, F32_KEYS) for hd in HEAD_DIMS)

launches = 0
layout_copies = 0
_fn = None
_STRIDES = ctypes.c_longlong * 12     # (batch, sequence, head) of q, k, v, o


@dataclass(frozen=True)
class Launch:
    """One launch of the library: ``rows`` query rows and ``keys`` keys per
    K/V tile per CTA, ``warpgroups`` bf16 consumer warpgroups (0 for the
    float32 kernel), ``threads`` per CTA, the ``grid`` (batch * heads,
    query tiles), dynamic ``smem_bytes``, and the TMA boxes as (columns,
    rows) of q and of k/v (None for the float32 kernel, which loads
    element-wise)."""

    dtype: str
    head_dim: int
    rows: int
    keys: int
    warpgroups: int
    threads: int
    grid: tuple[int, int]
    smem_bytes: int
    q_box: tuple[int, int] | None
    kv_box: tuple[int, int] | None

    @property
    def instance(self) -> tuple[str, int, int, int]:
        """The kernel of :data:`INSTANCES` this launch runs."""
        return self.dtype, self.head_dim, self.warpgroups, self.keys


def padded_head_dim(head_dim: int) -> int:
    """The width of a bf16 CTA's tiles (csrc ``padded_hd``): the head dim,
    or 128 for 80, whose columns past 80 the TMA fills with zeros."""
    return 128 if head_dim == 80 else head_dim


def smem_bytes(head_dim: int, warpgroups: int, keys: int) -> int:
    """Dynamic shared memory of a bf16 CTA (csrc ``bf16_smem_bytes``): the
    64-row Q tile, the K and V rings, the mbarriers and, with two
    warpgroups, the exchange in which the second hands its partial result
    to the first, all at the padded width."""
    hdp = padded_head_dim(head_dim)
    exchange = 4 * 128 * (hdp // 2 + 4) if warpgroups == 2 else 0
    return 2 * hdp * (ROWS + 2 * STAGES * keys) + 8 * (1 + 3 * STAGES) + exchange


def f32_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of a float32 CTA (csrc ``f32_smem_bytes``)."""
    return 4 * (F32_ROWS * (head_dim + 1) + 2 * F32_KEYS * (head_dim + 1)
                + F32_ROWS * (F32_KEYS + 1))


def choose_tile(B: int, NH: int, Sq: int, Skv: int) -> tuple[int, int]:
    """The bf16 tile.  Two warpgroups split a CTA's K/V tiles (even and odd)
    and merge when the grid fits the card in one wave of one CTA per SM
    and a CTA sees two K/V tiles or more: the longest chain of tiles
    halves, which beats the merge and the second warpgroup's registers.
    Otherwise one warpgroup takes every tile, two CTAs to an SM."""
    split = B * NH * -(-Sq // ROWS) <= SMS and Skv > TILES[1][1]
    return TILES[1] if split else TILES[0]


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, NH: int, Sq: int, Skv: int, head_dim: int, dtype: str) -> Launch:
    """The launch for q ``(B, Sq, NH, head_dim)`` and k/v of ``Skv`` keys of
    ``dtype`` ("float32" or "bfloat16").  Plain Python, decides nothing
    about a card.  Raises ``ValueError`` on a head dim or dtype the library
    lacks, or a grid past the launch limits."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == "bfloat16":
        warpgroups, keys = choose_tile(B, NH, Sq, Skv)
        rows, threads = ROWS, 128 * warpgroups + 32      # and one producer warp
        smem = smem_bytes(head_dim, warpgroups, keys)
        cols = min(head_dim, 64)          # one 128-byte (hd 32: 64-byte) swizzle row
        q_box, kv_box = (cols, rows), (cols, keys)
    elif dtype == "float32":
        warpgroups, rows, keys, threads = 0, F32_ROWS, F32_KEYS, F32_THREADS
        smem, q_box, kv_box = f32_smem_bytes(head_dim), None, None
    else:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}")
    grid = (B * NH, -(-Sq // rows))
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y:
        raise ValueError(f"B {B}, heads {NH} or Sq {Sq} exceeds the launch grid {grid}")
    return Launch(dtype, head_dim, rows, keys, warpgroups, threads, grid, smem, q_box, kv_box)


def _bsh(t: torch.Tensor) -> tuple[tuple[int, int, int], list[int]]:
    """(B, S, H) and their strides for a (B, S, H, hd) tensor, or for a
    (rows, S, hd) one read as (1, S, rows, hd).  A dimension of length 1 is
    never stepped along; its stride is given as hd, which any tensor map
    accepts."""
    shape, stride = t.shape, t.stride()
    hd = shape[-1]
    if len(shape) == 3:
        sizes, strides = (1, shape[1], shape[0]), (hd, stride[1], stride[0])
    else:
        sizes, strides = tuple(shape[:3]), stride[:3]
    return sizes, [st if n > 1 else hd for n, st in zip(sizes, strides)]


def launch_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Launch:
    """The launch :func:`attention` (4-d, model layout) or
    :func:`flash_attention` (3-d) makes for these tensors."""
    (B, Sq, NH), _ = _bsh(q)
    return choose_launch(B, NH, Sq, k.shape[1], q.shape[-1], str(q.dtype)[6:])


def readable(t: torch.Tensor) -> bool:
    """The kernel reads ``t`` (4-d or 3-d) in place: its last dimension is
    contiguous and, for bf16 (TMA), its base pointer and the strides of its
    other dimensions longer than 1 are nonzero multiples of 16 bytes below
    2**40."""
    shape, strides = t.shape, t.stride()
    if shape[-1] > 1 and strides[-1] != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    if t.data_ptr() % TMA_ALIGN:
        return False
    return all(n == 1 or (0 < 2 * st < TMA_MAX_STRIDE and 2 * st % TMA_ALIGN == 0)
               for n, st in zip(shape[:-1], strides[:-1]))


def prepare(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor as it is if the kernel reads it in place, else one fresh
    contiguous copy, counted in ``layout_copies``."""
    global layout_copies
    out = []
    for t in tensors:
        if not readable(t):
            t = t.clone(memory_format=torch.contiguous_format)
            layout_copies += 1
        out.append(t)
    return out


def stride_args(*tensors: torch.Tensor) -> list[int]:
    """The batch, sequence and head strides (elements) of each tensor, as
    the library takes them (see :func:`_bsh`)."""
    return [st for t in tensors for st in _bsh(t)[1]]


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        fn = build.load(SOURCE).flash_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: int, dims: int) -> None:
    """Raises ``ValueError`` on anything the library cannot run; the
    device last, so that every other refusal shows on CPU tensors too."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != dims or t.shape[-1] != q.shape[-1]:
            raise ValueError(f"{name} must be {dims}-d with head_dim {q.shape[-1]}; "
                             f"got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must all be float32 or all bfloat16; {name} is {t.dtype}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    heads, kv_heads = q.shape[-2 if dims == 4 else 0], k.shape[-2 if dims == 4 else 0]
    if group < 1 or heads != kv_heads * group:
        raise ValueError(f"q heads {heads} != kv heads {kv_heads} * group {group}")
    if dims == 4 and k.shape[0] != q.shape[0]:
        raise ValueError(f"batch of q {q.shape[0]} and k {k.shape[0]} differ")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: the kernel takes its local shard "
                            "(ops.mha_flash runs it through local_map)")
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"q, k and v must share one device; {name} is on {t.device}")


def _launch(q, k, v, o, lse, group, scale, softcap, causal, window) -> None:
    """Launch on q, k, v, o, all 4-d (model layout) or all 3-d, writing
    the LSE into ``lse`` unless it is None."""
    global launches
    q, k, v = prepare(q, k, v)
    (B, Sq, NH), q_strides = _bsh(q)
    hd = q.shape[-1]
    launch = choose_launch(B, NH, Sq, k.shape[1], hd, str(q.dtype)[6:])
    strides = _STRIDES(*q_strides, *_bsh(k)[1], *_bsh(v)[1], *_bsh(o)[1])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), int(q.dtype == torch.bfloat16),
        B, NH, group, Sq, k.shape[1], hd, strides,
        float(scale), float(softcap), int(bool(causal)), int(window or 0),
        launch.warpgroups, launch.keys, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: error {err} ({launch})")
    launches += 1


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad is enabled and one of ``tensors`` requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attend(q, k, v, *, group=1, scale=None, softcap=0.0, causal=True, window=0,
           with_lse=False):
    """The forward kernel on q, k, v, all 4-d (model layout) or all 3-d,
    with no gradient: a fresh contiguous output of q's shape and, with
    ``with_lse``, the rows' float32 log-sum-exp ``(B, NH, Sq)`` (3-d:
    ``(BH, Sq)``), else None."""
    _check(q, k, v, group, q.dim())
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = None
    if with_lse:
        rows = (q.shape[0], q.shape[2], q.shape[1]) if q.dim() == 4 else q.shape[:2]
        lse = torch.empty(rows, dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, lse, group, scale, softcap, causal, window)
    return o, lse


def _differentiable(q, k, v, **kw) -> torch.Tensor:
    from .ops import FlashAttention

    return FlashAttention.apply(q, k, v, kw["group"], kw["scale"], kw["softcap"],
                                kw["causal"], kw["window"])[0]


def attention(
    q: torch.Tensor,           # (B, Sq, NH, hd), any strides
    k: torch.Tensor,           # (B, Skv, NKV, hd)
    v: torch.Tensor,           # (B, Skv, NKV, hd)
    *,
    group: int = 1,            # q heads per kv head (GQA): NH == NKV * group
    scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """The kernel on model-layout CUDA tensors, read through their strides;
    returns a fresh contiguous ``(B, Sq, NH, hd)``, differentiable when
    an input needs a gradient.  Raises on anything else."""
    _check(q, k, v, group, 4)
    kw = dict(group=group, scale=scale, softcap=softcap, causal=causal, window=window)
    if needs_grad(q, k, v):
        return _differentiable(q, k, v, **kw)
    return attend(q, k, v, **kw)[0]


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
    """Launch the Hopper kernel on CUDA tensors, differentiable when an
    input needs a gradient; raises on anything else."""
    _check(q, k, v, group, 3)
    kw = dict(group=group, scale=scale, softcap=softcap, causal=causal, window=window)
    if needs_grad(q, k, v):
        return _differentiable(q, k, v, **kw)
    return attend(q, k, v, **kw)[0]
