"""Hopper rotary position embeddings (B9): ctypes wrapper over
``csrc/rotary.cu``.

Every RoPE of the port's models (``layers.apply_rope``: q and k of dense
attention, MLA's ``q_rope`` and ``k_rope``), forward and backward: XLA's
fusion of the JAX package's ``models/layers.py:79-88`` inside its jitted
step, not a TPU kernel.  :func:`rotary` is one kernel launch: x read once
through its strides, rotated by float32 cos and sin tables, written once
in x's dtype, contiguous.  ``negate`` rotates by ``-sin``: the gradient.
The plain version is :func:`.ref.rotary_ref`; the tables come from
:func:`.ref.rope_tables` on both routes, so the kernel gives the plain
version's bits.

Routing.  CPU and meta tensors take the plain version through
:func:`repro_torch.kernels.run_plain` (the dry run counts it as one
launch); CUDA tensors launch the kernel or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`): :mod:`.ops` runs
the local shards.  The checks are plain Python and run before the
routing: x float32 or bfloat16 ``(B, S, heads, head_dim)`` with an even
head_dim, cos and sin float32 of one shape that broadcasts to ``(B, S,
head_dim / 2)``, all on one device.

Layout.  x's last dimension must be contiguous, else it is copied once,
counted in ``layout_copies``; its other strides may be anything (a head
slice, a view in wider rows).  ``launches`` counts the calls that
launched the kernel from Python or recorded it into a CUDA graph under
capture; no tokens launch nothing and count nothing.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import run_plain, takes_plain

from .ref import rotary_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rotary.cu"
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 128                 # threads a block, one block a token (csrc THREADS)
VEC = 4                       # elements a vector load where every row sits on 4 elements
MAX_TOKENS = 2**31 - 1        # the grid's x limit

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def check(x, cos, sin) -> None:
    for what, t in (("x", x), ("cos", cos), ("sin", sin)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rotary: {what} is {type(t).__name__}, not a tensor")
        takes_plain(t)
    if x.dtype not in DTYPES:
        raise ValueError(f"rotary: x is {x.dtype}; B9 takes {DTYPES}")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rotary: x {tuple(x.shape)} is not (B, S, heads, head_dim) with an "
                         "even head_dim")
    want = (x.shape[0], x.shape[1], x.shape[-1] // 2)
    for what, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"rotary: {what} must be float32 on {x.device}; got {t.dtype} on "
                             f"{t.device}")
        try:
            fits = t.shape == cos.shape and torch.broadcast_shapes(t.shape, want) == want
        except RuntimeError:
            fits = False
        if not fits:
            raise ValueError(f"rotary: {what} {tuple(t.shape)} does not broadcast to {want}")


def vectors(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> int:
    """Every row of x, the tables and the output sits on :data:`VEC`
    elements: the kernel reads and writes them 4 at a time."""
    half = x.shape[-1] // 2
    ok = half % VEC == 0
    for t in (x, cos, sin):
        ok = ok and t.data_ptr() % (VEC * t.element_size()) == 0
        ok = ok and all(n == 1 or st % VEC == 0
                        for n, st in zip(t.shape[:-1], t.stride()[:-1]))
    return int(ok)


def library(device: torch.device):
    """The library, loaded once, its kernels loaded on ``device`` once (a
    CUDA graph capture then never loads one)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        for name in ("rotary_init", "rotary_threads"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.rotary.argtypes = [_P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _LL, _LL, _I, _I,
                               _I, _P, _P]
        lib.rotary.restype = _I
        if lib.rotary_threads() != THREADS:
            raise RuntimeError(f"rotary: the library's blocks have {lib.rotary_threads()} "
                               f"threads, the wrapper plans for {THREADS}")
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            raise_on(_lib.rotary_init(), "rotary_init")
        _ready_devices.add(index)
    return _lib


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *, negate: bool = False
           ) -> torch.Tensor:
    """x ``(B, S, heads, head_dim)`` rotated by the float32 tables ``cos``
    and ``sin`` (broadcast to ``(B, S, head_dim / 2)``), by ``-sin`` with
    ``negate``: x's shape and dtype, contiguous."""
    global launches, layout_copies
    check(x, cos, sin)
    if takes_plain(x):
        with torch.no_grad():
            return run_plain(functools.partial(rotary_ref, negate=negate), x, cos, sin)
    if x.stride(-1) != 1:
        layout_copies += 1
        x = x.contiguous()
    B, S, H, hd = x.shape
    half = hd // 2
    c = torch.broadcast_to(cos, (B, S, half))
    s = torch.broadcast_to(sin, (B, S, half))
    if c.stride() != s.stride() or c.stride(-1) != 1:
        layout_copies += 1
        c, s = c.contiguous(), s.contiguous()
    out = torch.empty(B, S, H, hd, dtype=x.dtype, device=x.device)
    if not out.numel():
        return out
    if B * S > MAX_TOKENS:
        raise ValueError(f"rotary: {B * S} tokens, more than the grid's {MAX_TOKENS}")
    err = library(x.device).rotary(
        x.data_ptr(), B, S, H, half, x.stride(0), x.stride(1), x.stride(2), c.data_ptr(),
        s.data_ptr(), c.stride(0), c.stride(1), int(negate), int(x.dtype == torch.bfloat16),
        vectors(x, c, s), out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "rotary")
    launches += 1
    return out
