"""Hopper expanded attention (B7): ctypes wrapper over ``csrc/expanded_attention.cu``.

Multi-head latent attention's expanded form (DeepSeek-V2), the attention
that training and ``forward`` run (``models/mla.py``'s expanded core):
``q_nope`` ``(B, S, N, nope)`` and ``q_rope`` ``(B, S, N, rope)`` against
``k_nope`` ``(B, T, N, nope)``, ``k_rope`` ``(B, T, rope)`` (one rope key
for all N heads) and ``v`` ``(B, T, N, dv)``, each read through its strides;
key t is visible to the query at ``q_pos[s]`` when ``q_pos[s] >= t``, with
``q_pos`` ``(S,)`` read on the device; float32 logits, softmax and sums;
the context ``(B, S, N, dv)`` in the inputs' dtype.  It replaces no TPU
kernel: the JAX package computes this in jnp
(``src/repro/models/mla.py:90-103``), which the port's plain version,
:func:`.ref.expanded_attention_ref`, repeats with the (B, N, S, T) float32
scores in memory.  B1 cannot take it: its q, k and v share one head dim.

Contract: nope up to 128, rope up to 64, dv up to 128, each a multiple of
16; float32 or bf16; any B, S, N, T.  Anything else raises, on CPU tensors
too.

Routing.  CPU and meta tensors take the plain version through
:func:`repro_torch.kernels.run_plain` (the dry run counts it as one
launch); CUDA tensors launch the kernel or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`: the sharded path
reaches B7 on each device's heads through ``on_local_shards``).  With grad
enabled and an input that needs it, the call goes through
:class:`.ops.ExpandedAttention`, whose forward also writes each row's
log-sum-exp and whose backward is the backward kernel (:mod:`.backward`).

bf16 runs on the tensor cores (``wgmma`` fed by a TMA ring: 128 query rows
of one head a CTA, 64 for each of two consumer warpgroups that take turns
at the tensor cores, each with a 64 x 192 Q tile of two nope boxes and one
rope box, ``KEYS``-key K tiles read the same way from k_nope and k_rope, V
tiles ``KEYS`` x 128; the design is in the ``.cu`` file's note).  float32
runs on the FMA units (no TF32).  The plan (:func:`choose_launch`, plain Python) depends on shapes
only, never on ``q_pos``.  A tensor whose last dimension is not contiguous,
or whose base or strides are off 16 bytes, is copied once here and counted
in ``layout_copies`` (0 on the model's paths).

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture; a graph replay runs it again
without passing through here.  A call is one kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import needs_grad, readable, run_plain, takes_plain

from .ref import expanded_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "expanded_attention.cu"
NOPES = tuple(range(16, 129, 16))    # nope widths the kernels take
ROPES = (16, 32, 48, 64)             # rope widths
VALUES = tuple(range(16, 129, 16))   # v widths
ROWS = {"bfloat16": 128, "float32": 64}   # query rows a CTA (csrc CTA_ROWS, BM)
KEYS = 64                            # bf16: keys a tile (csrc BN)
F_KEYS = 64                          # float32: keys a tile (csrc F_BN)
BOX_BYTES = 64 * 128                 # one TMA box of Q: 64 rows of 64 bf16 columns
STAGES = 4                           # bf16: the K/V ring (csrc STAGES)
THREADS = {"bfloat16": 288, "float32": 256}
MAX_SMEM = 232448                    # a CTA's largest dynamic shared memory (227 KB)
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535
# the library's kernels by (dtype, direction): phase 3d of chip_smoke.py
# launches each of them
INSTANCES = tuple((dt, way) for dt in ("bfloat16", "float32") for way in ("forward", "backward"))

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()
_STRIDES = ctypes.c_longlong * 17     # q_nope 3, q_rope 3, k_nope 3, k_rope 2, v 3, o 3


@dataclass(frozen=True)
class Launch:
    """One forward launch: the grid (batch x heads, query tiles; bf16
    launches it as one dimension of their product, the (batch, head)
    outermost, so that the CTAs in flight share a few heads' K and V in
    the L2), threads
    a CTA and dynamic shared memory."""

    dtype: str
    grid: tuple[int, int]
    threads: int
    smem_bytes: int


def smem_bytes(dtype: str) -> int:
    """Dynamic shared memory of a forward CTA (csrc ``bf16_smem_bytes``,
    ``f32_smem_bytes``).  bf16: the two consumer warpgroups' Q tiles (three
    8 KB boxes each), ``STAGES`` stages of a K tile (three boxes of
    ``KEYS`` rows) and a V tile (two), 1 + 4 * STAGES mbarriers, the CTA's
    key limit and its warpgroups' smallest positions.  float32: Q and K
    tiles of 193 columns, V of 129, P of 65 (float32), the limit."""
    if dtype == "bfloat16":
        return (2 * 3 * BOX_BYTES + STAGES * 5 * KEYS * 128 + 8 * (1 + 4 * STAGES) + 16)
    rows = ROWS["float32"]
    return 4 * (rows * 193 + F_KEYS * 193 + F_KEYS * 129 + rows * 65) + 16


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, S: int, N: int, T: int, nope: int, rope: int, dv: int,
                  dtype: str) -> Launch:
    """The forward launch for ``B`` batch rows of ``S`` queries and ``N``
    heads over ``T`` keys at these widths and ``dtype`` ("float32" or
    "bfloat16").  Plain Python, a function of the shapes alone.  Raises
    ``ValueError`` on widths or a dtype the library lacks, an empty shape or
    a grid past the launch limits."""
    if nope not in NOPES or rope not in ROPES or dv not in VALUES:
        raise ValueError(f"expanded_attention: nope {nope}, rope {rope} and v {dv} must be "
                         f"multiples of 16, nope and v at most 128, rope at most 64")
    if dtype not in THREADS:
        raise ValueError(f"expanded_attention takes float32 or bfloat16, not {dtype}")
    if min(B, S, N, T) < 1:
        raise ValueError(f"expanded_attention: empty shape B {B} S {S} N {N} T {T}")
    grid = (B * N, -(-S // ROWS[dtype]))
    # 64-row tiles bound both dtypes (the float32 grid's, the backward's);
    # bf16 launches the grid as one dimension
    if (grid[0] > MAX_GRID_X or -(-S // ROWS["float32"]) > MAX_GRID_Y
            or (dtype == "bfloat16" and grid[0] * grid[1] > MAX_GRID_X)):
        raise ValueError(f"expanded_attention: grid {grid} exceeds the launch limits")
    smem = smem_bytes(dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"expanded_attention: a CTA takes {smem} bytes of shared memory; it "
                         f"has {MAX_SMEM}")
    return Launch(dtype, grid, THREADS[dtype], smem)


def launch_for(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
               v: torch.Tensor) -> Launch:
    """The forward launch :func:`expanded_attention` makes for these tensors."""
    B, S, N, nope = q_nope.shape
    return choose_launch(B, S, N, k_nope.shape[1], nope, q_rope.shape[-1], v.shape[-1],
                         str(q_nope.dtype)[6:])


def prepare(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor as it is if the kernels read it in place
    (:func:`repro_torch.kernels.readable`: the last dimension contiguous,
    the base and the other strides multiples of 16 bytes, as the TMA needs),
    else one fresh contiguous copy, counted in ``layout_copies``."""
    global layout_copies
    out = []
    for t in tensors:
        if not readable(t):
            t = t.clone(memory_format=torch.contiguous_format)
            layout_copies += 1
        out.append(t)
    return out


def positions(q_pos: torch.Tensor) -> torch.Tensor:
    """``q_pos`` as int64, the kernels' index type (a counted copy
    otherwise)."""
    global layout_copies
    if q_pos.dtype == torch.int64:
        return q_pos
    layout_copies += 1
    return q_pos.to(torch.int64)


def strides(t: torch.Tensor, width: int) -> list[int]:
    """The strides of every dimension but the last, in elements; one of
    length 1 is never stepped along and is given as ``width`` (a stride
    any tensor map takes)."""
    return [st if n > 1 else width for n, st in zip(t.shape[:-1], t.stride()[:-1])]


def _kernel(device: torch.device):
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.expanded_attention_init.argtypes = []
        lib.expanded_attention_init.restype = ctypes.c_int
        lib.expanded_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.expanded_attention_fwd.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.expanded_attention_init()
        if err != 0:
            raise RuntimeError(f"expanded_attention_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def check(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale) -> None:
    """Raises ``ValueError`` on inputs neither version takes, whatever the
    device (``TypeError`` on a DTensor)."""
    named = (("q_nope", q_nope), ("q_rope", q_rope), ("k_nope", k_nope), ("k_rope", k_rope),
             ("v", v))
    for name, t in named:
        takes_plain(t)
        if t.dtype != q_nope.dtype:
            raise ValueError(f"expanded_attention: every input shares q_nope's dtype "
                             f"{q_nope.dtype}; {name} is {t.dtype}")
        if t.device != q_nope.device:
            raise ValueError(f"expanded_attention: {name} is on {t.device}, q_nope on "
                             f"{q_nope.device}")
    if q_nope.dim() != 4 or q_rope.dim() != 4 or q_rope.shape[:3] != q_nope.shape[:3]:
        raise ValueError(f"expanded_attention: q_nope {tuple(q_nope.shape)} and q_rope "
                         f"{tuple(q_rope.shape)} must be (B, S, N, nope) and (B, S, N, rope)")
    B, S, N, nope = q_nope.shape
    if (k_nope.dim() != 4 or v.dim() != 4 or k_rope.dim() != 3 or k_nope.shape[0] != B
            or k_nope.shape[2:] != (N, nope) or v.shape[:3] != k_nope.shape[:3]
            or k_rope.shape != (B, k_nope.shape[1], q_rope.shape[3])):
        raise ValueError(f"expanded_attention: k_nope {tuple(k_nope.shape)}, k_rope "
                         f"{tuple(k_rope.shape)} and v {tuple(v.shape)} must be (B={B}, T, "
                         f"N={N}, nope={nope}), (B, T, rope={q_rope.shape[3]}) and (B, T, N, dv)")
    takes_plain(q_pos)
    if q_pos.shape != (S,) or q_pos.is_floating_point():
        raise ValueError(f"expanded_attention: q_pos must be integer ({S},); got {q_pos.dtype} "
                         f"{tuple(q_pos.shape)}")
    if q_pos.device != q_nope.device:
        raise ValueError(f"expanded_attention: q_pos is on {q_pos.device}, q_nope on "
                         f"{q_nope.device}")
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"expanded_attention: scale {scale} must be finite and positive")
    launch_for(q_nope, q_rope, k_nope, v)


def attend(q_nope, q_rope, k_nope, k_rope, v, q_pos, *, scale, with_lse=False):
    """The forward kernel on CUDA tensors, with no gradient: a fresh
    contiguous ``(B, S, N, dv)`` output and, with ``with_lse``, the rows'
    float32 log-sum-exp ``(B, N, S)``, else None."""
    global launches
    scale = float(scale)
    check(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale)
    launch = launch_for(q_nope, q_rope, k_nope, v)
    q_nope, q_rope, k_nope, k_rope, v = prepare(q_nope, q_rope, k_nope, k_rope, v)
    q_pos = positions(q_pos)
    B, S, N, nope = q_nope.shape
    T, rope, dv = k_nope.shape[1], q_rope.shape[-1], v.shape[-1]
    dev = q_nope.device
    o = torch.empty((B, S, N, dv), dtype=q_nope.dtype, device=dev)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=dev) if with_lse else None
    st = _STRIDES(*strides(q_nope, nope), *strides(q_rope, rope), *strides(k_nope, nope),
                  *strides(k_rope, rope), *strides(v, dv), *strides(o, dv))
    lib = _kernel(dev)
    err = lib.expanded_attention_fwd(
        q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(),
        v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(), q_pos.data_ptr(),
        st, q_pos.stride(0), int(q_nope.dtype == torch.bfloat16), B, S, N, T, nope, rope, dv,
        launch.smem_bytes, scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"expanded_attention launch failed: error {err} ({launch})")
    launches += 1
    return o, lse


def _plain_out(q_nope, q_rope, k_nope, k_rope, v, q_pos, *, scale):
    return expanded_attention_ref(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale=scale)[0]


def expanded_attention(
    q_nope: torch.Tensor,     # (B, S, N, nope), any strides
    q_rope: torch.Tensor,     # (B, S, N, rope)
    k_nope: torch.Tensor,     # (B, T, N, nope)
    k_rope: torch.Tensor,     # (B, T, rope): one rope key for every head
    v: torch.Tensor,          # (B, T, N, dv)
    q_pos: torch.Tensor,      # (S,) int64
    *,
    scale: float,
) -> torch.Tensor:
    """The expanded form's context ``(B, S, N, dv)`` in the inputs' dtype,
    as :func:`.ref.expanded_attention_ref` computes it; differentiable when
    an input needs a gradient (:class:`.ops.ExpandedAttention`)."""
    scale = float(scale)
    check(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale)
    if needs_grad(q_nope, q_rope, k_nope, k_rope, v):
        from .ops import ExpandedAttention

        return ExpandedAttention.apply(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale)[0]
    if takes_plain(q_nope):
        return run_plain(functools.partial(_plain_out, scale=scale), q_nope, q_rope, k_nope,
                         k_rope, v, q_pos)
    return attend(q_nope, q_rope, k_nope, k_rope, v, q_pos, scale=scale)[0]
