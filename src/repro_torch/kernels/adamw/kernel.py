"""Hopper AdamW (B4): ctypes wrapper over ``csrc/adamw.cu``.

The optimizer update of a training step: XLA's fusion of the JAX package's
``optim/adamw.py:29-71`` inside the jitted step, not a TPU kernel.  Three
functions, each launching one kernel a leaf (the finish one kernel):

* :func:`adamw_sumsq`: each gradient's float32 sum of squares, read once,
  into a float32 buffer of ``n + 4`` values, the sums then room for
  :func:`adamw_finish`'s four scalars;
* :func:`adamw_finish`: the leaves' sums added in tree order, the global
  norm, the clip scale and, given the int32 step counter, the step
  advanced in place and the bias corrections, written to the buffer's last
  four values ``{norm, scale, bc1, bc2}`` (a view, returned);
* :func:`adamw_step`: JAX's ``upd`` for every leaf, the gradient clipped
  in its own dtype, the moments float32, the parameter rounded to its
  dtype, each read once and written once in place.  The scalars and a
  tensor ``lr`` are read on the device: a captured CUDA graph reads each
  replay's own.

Their plain versions are in :mod:`.ref`.

Routing.  CPU and meta tensors take the plain versions through
:func:`repro_torch.kernels.run_plain`, naming the tensors each writes in
place (the dry run counts each pass as one launch); CUDA tensors launch the
kernels or raise; a ``DTensor`` raises ``TypeError``
(:func:`repro_torch.kernels.takes_plain`): the optimizer passes each
device's local shards.  The checks of the inputs are plain Python and run
before the routing: parameters and gradients bf16 or float32 and of one
dtype a leaf, moments float32, every leaf contiguous, on one device, of one
shape in the four trees.

The plan of a leaf (:func:`choose_launch`) is a function of its size and
dtype alone: the sum of squares adds in one order whatever the leaf's
address, so replays repeat bit for bit.  ``launches`` counts the kernels
launched from Python, or recorded into a CUDA graph under capture (a
leaf's sum or update is one kernel, the finish one).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import run_plain, takes_plain

from .ref import adamw_step_ref, bias_corrections_ref, norm_scale_ref, sumsq_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
THREADS = 256                 # threads a block (csrc THREADS)
MAX_BLOCKS = 132 * 4          # a leaf's largest grid: 4 blocks on each of an H100's 132 SMs
VEC = 16                      # bytes a vector load (csrc VEC_BYTES)
HEAD = 4                      # floats before the sums: the ticket counter, padded to 16 bytes
SCALARS = 4                   # norm, clip scale, bc1, bc2
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()

_P = ctypes.c_void_p


@dataclass(frozen=True)
class Launch:
    """One leaf's plan: ``vec`` elements a 16-byte vector, ``nvec`` whole
    vectors and ``tail`` elements after them, ``grid`` blocks of
    :data:`THREADS` (and as many float32 partials of the sum)."""

    vec: int
    nvec: int
    tail: int
    grid: int


@functools.lru_cache(maxsize=4096)
def choose_launch(numel: int, dtype: str) -> Launch:
    """The plan for a leaf of ``numel`` elements of ``dtype`` ("float32" or
    "bfloat16"): thread t of block b takes vectors ``b·THREADS + t`` and
    every ``grid·THREADS`` after, block 0's threads the tail; ``grid``
    covers the vectors once, at most :data:`MAX_BLOCKS`.  Plain Python, a
    function of these two alone."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"adamw takes float32 or bfloat16 leaves, not {dtype}")
    if numel < 0:
        raise ValueError(f"adamw: a leaf of {numel} elements")
    vec = VEC // (4 if dtype == "float32" else 2)
    nvec, tail = divmod(numel, vec)
    grid = max(1, min(-(-nvec // THREADS), MAX_BLOCKS))
    return Launch(vec, nvec, tail, grid)


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous, else one contiguous copy, counted in
    ``layout_copies``: autograd may give a gradient in the layout of the
    product it came from."""
    global layout_copies
    if t.is_contiguous():
        return t
    layout_copies += 1
    return t.contiguous()


def _name(t: torch.Tensor) -> str:
    return str(t.dtype)[len("torch."):]


def _check_leaf(t, what: str, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"adamw: {what} is {type(t).__name__}, not a tensor")
    takes_plain(t)
    if t.device != device:
        raise ValueError(f"adamw: {what} is on {t.device}, the first leaf on {device}")
    if not t.is_contiguous():
        raise ValueError(f"adamw: {what} is not contiguous (shape {tuple(t.shape)}, strides "
                         f"{t.stride()})")


def check_grads(leaves) -> torch.device:
    """The leaves' one device; raises on an empty tree, a dtype other than
    bf16 or float32, a non-contiguous leaf or a second device."""
    if not leaves:
        raise ValueError("adamw: an empty tree")
    device = leaves[0].device if isinstance(leaves[0], torch.Tensor) else None
    for i, g in enumerate(leaves):
        _check_leaf(g, f"leaf {i}", device)
        if g.dtype not in DTYPES:
            raise ValueError(f"adamw: leaf {i} is {g.dtype}; B4 takes float32 or bfloat16")
    return device


def check_trees(grads, mus, nus, params) -> torch.device:
    """As :func:`check_grads` over all four trees, and: one length, one
    shape a leaf, the gradient in the parameter's dtype, float32 moments."""
    if not len(grads) == len(mus) == len(nus) == len(params):
        raise ValueError(f"adamw: trees differ: {len(params)} params, {len(grads)} grads, "
                         f"{len(mus)} and {len(nus)} moments")
    device = check_grads(params)
    for i, (g, m, v, p) in enumerate(zip(grads, mus, nus, params)):
        for what, t in (("gradient", g), ("first moment", m), ("second moment", v)):
            _check_leaf(t, f"leaf {i}'s {what}", device)
            if t.shape != p.shape:
                raise ValueError(f"adamw: leaf {i}'s {what} is {tuple(t.shape)}, its parameter "
                                 f"{tuple(p.shape)}")
        if g.dtype != p.dtype:
            raise ValueError(f"adamw: leaf {i}'s gradient is {g.dtype}, its parameter {p.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"adamw: leaf {i}'s moments are {m.dtype} and {v.dtype}, not "
                             "float32")
    return device


def _check_scalar(t, what: str, dtype, device, shape=()) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"adamw: {what} must be a {dtype} tensor of shape {shape}")
    takes_plain(t)
    if t.device != device:
        raise ValueError(f"adamw: {what} is on {t.device}, the leaves on {device}")


def _kernel(device: torch.device):
    """The library, loaded once, its kernels loaded on ``device`` once (a
    CUDA graph capture then never loads one)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.adamw_init.argtypes = []
        lib.adamw_init.restype = ctypes.c_int
        lib.adamw_threads.argtypes = []
        lib.adamw_threads.restype = ctypes.c_int
        lib.adamw_sumsq.argtypes = [ctypes.c_int] + [_P] * 7 + [_P, ctypes.c_int, _P, _P]
        lib.adamw_sumsq.restype = ctypes.c_int
        lib.adamw_finish.argtypes = [_P, ctypes.c_int, _P, _P] + [ctypes.c_float] * 3 + [_P]
        lib.adamw_finish.restype = ctypes.c_int
        lib.adamw_step.argtypes = ([ctypes.c_int] + [_P] * 11 + [ctypes.c_float] * 7
                                   + [ctypes.c_int, _P])
        lib.adamw_step.restype = ctypes.c_int
        if lib.adamw_threads() != THREADS:
            raise RuntimeError(f"adamw: the library's blocks have {lib.adamw_threads()} threads, "
                               f"the wrapper plans for {THREADS}")
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            _raise(_lib.adamw_init(), "adamw_init")
        _ready_devices.add(index)
    return _lib


def load(device: torch.device) -> None:
    """Build the library if need be and load its kernels on ``device``
    (a CUDA device): a CUDA graph captured after this loads nothing."""
    _kernel(device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _plans(leaves) -> list[Launch]:
    return [choose_launch(t.numel(), _name(t)) for t in leaves]


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _sumsq_plain(leaves, index, n):
    sums = sumsq_ref(leaves)
    if len(index) == n:
        return torch.cat([sums, sums.new_zeros(SCALARS)])
    zero = sums.new_zeros(())
    vals = [zero] * (n + SCALARS)
    for i, s in zip(index, sums.unbind(0)):
        vals[i] = s
    return torch.stack(vals)


def adamw_sumsq(leaves: list[torch.Tensor], keep: list[bool] | None = None) -> torch.Tensor:
    """``(n + 4,)`` float32: each leaf's float32 sum of squares (0 for a
    leaf whose ``keep`` is False, which is not read), then four values for
    :func:`adamw_finish`."""
    global launches
    device = check_grads(leaves)
    n = len(leaves)
    if keep is not None and len(keep) != n:
        raise ValueError(f"adamw: keep has {len(keep)} entries for {n} leaves")
    index = [i for i in range(n) if keep is None or keep[i]]
    kept = [leaves[i] for i in index]
    if takes_plain(leaves[0]):
        if not kept:        # the kernel's memset alone: every sum 0
            return leaves[0].new_zeros(n + SCALARS, dtype=torch.float32)
        with torch.no_grad():
            return run_plain(_sumsq_plain, kept, index, n)
    plans = _plans(kept)
    ws = torch.empty(HEAD + n + SCALARS + MAX_BLOCKS, dtype=torch.float32, device=device)
    base = ws.data_ptr()
    err = _kernel(device).adamw_sumsq(
        len(kept), _array(ctypes.c_ulonglong, [t.data_ptr() for t in kept]),
        _array(ctypes.c_int, [int(t.dtype == torch.bfloat16) for t in kept]),
        _array(ctypes.c_longlong, [pl.nvec for pl in plans]),
        _array(ctypes.c_int, [pl.tail for pl in plans]),
        _array(ctypes.c_int, [pl.grid for pl in plans]),
        _array(ctypes.c_int, [int(t.data_ptr() % VEC == 0) for t in kept]),
        _array(ctypes.c_int, index), base, n, base + 4 * (HEAD + n + SCALARS), _stream(device))
    _raise(err, "adamw_sumsq")
    launches += len(kept)
    return ws[HEAD:HEAD + n + SCALARS]


def _finish_plain(sums, out, step, *, max_norm, b1, b2):
    norm, scale = norm_scale_ref(sums, max_norm)
    if step is None:
        bc1 = bc2 = torch.ones_like(norm)
    else:
        bc1, bc2 = bias_corrections_ref(step, b1, b2)
    out.copy_(torch.stack([norm, scale, bc1, bc2]))


def adamw_finish(buf: torch.Tensor, step: torch.Tensor | None, *, max_norm: float,
                 b1: float = 0.9, b2: float = 0.95) -> torch.Tensor:
    """From :func:`adamw_sumsq`'s ``buf``: writes ``{norm, scale, bc1,
    bc2}`` to its last four values and returns them (a view).  The sums
    are added in tree order; ``scale = min(1, max_norm / (norm + 1e-9))``;
    with ``step`` (0-d int32) the step is advanced in place and ``bc = 1 -
    b**step``, without it both are 1."""
    global launches
    if buf.dim() != 1 or buf.dtype != torch.float32 or buf.numel() <= SCALARS:
        raise ValueError(f"adamw: buf must be adamw_sumsq's (n + {SCALARS},) float32; got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    takes_plain(buf)
    n = buf.numel() - SCALARS
    if step is not None:
        _check_scalar(step, "the step counter", torch.int32, buf.device)
    sums, out = buf[:n], buf[n:]
    if takes_plain(buf):
        with torch.no_grad():
            run_plain(functools.partial(_finish_plain, max_norm=max_norm, b1=b1, b2=b2),
                      sums, out, step, writes=(out,) if step is None else (out, step))
        return out
    err = _kernel(buf.device).adamw_finish(sums.data_ptr(), n, out.data_ptr(),
                                 None if step is None else step.data_ptr(), max_norm, b1, b2,
                                 _stream(buf.device))
    _raise(err, "adamw_finish")
    launches += 1
    return out


def _step_plain(grads, mus, nus, params, scalars, lr, *, clip, **hyper):
    scale = scalars[1] if clip else None
    for g, m, v, p in zip(grads, mus, nus, params):
        adamw_step_ref(g, m, v, p, scale=scale, lr=lr, bc1=scalars[2], bc2=scalars[3], **hyper)


def adamw_step(grads: list[torch.Tensor], mus: list[torch.Tensor], nus: list[torch.Tensor],
               params: list[torch.Tensor], scalars: torch.Tensor, lr: float | torch.Tensor, *,
               b1: float, b2: float, eps: float, weight_decay: float, clip: bool) -> None:
    """Every leaf's AdamW update in place, with :func:`adamw_finish`'s
    ``scalars``: the gradient times the scale cast to its dtype (``clip``),
    the moments ``b·m + (1 - b)·g`` and ``b·v + (1 - b)·g·g``, the
    parameter ``p - lr·((m/bc1) / (sqrt(v/bc2) + eps) + weight_decay·p)``
    rounded to its dtype.  ``lr`` is a number or a 0-d float32 tensor."""
    global launches
    device = check_trees(grads, mus, nus, params)
    _check_scalar(scalars, "scalars", torch.float32, device, (SCALARS,))
    if isinstance(lr, torch.Tensor):
        _check_scalar(lr, "lr", torch.float32, device)
    elif not isinstance(lr, (int, float)):
        raise ValueError(f"adamw: lr must be a number or a 0-d float32 tensor, not "
                         f"{type(lr).__name__}")
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if takes_plain(params[0]):
        with torch.no_grad():
            run_plain(functools.partial(_step_plain, clip=clip, **hyper), grads, mus, nus,
                      params, scalars, lr, writes=(mus, nus, params))
        return
    plans = _plans(params)
    ptrs = [[t.data_ptr() for t in tree] for tree in (grads, mus, nus, params)]
    tensor_lr = isinstance(lr, torch.Tensor)
    err = _kernel(device).adamw_step(
        len(params), *(_array(ctypes.c_ulonglong, p) for p in ptrs),
        _array(ctypes.c_int, [int(p.dtype == torch.bfloat16) for p in params]),
        _array(ctypes.c_longlong, [pl.nvec for pl in plans]),
        _array(ctypes.c_int, [pl.tail for pl in plans]),
        _array(ctypes.c_int, [pl.grid for pl in plans]),
        _array(ctypes.c_int, [int(all(p[i] % VEC == 0 for p in ptrs))
                              for i in range(len(params))]),
        scalars.data_ptr(), lr.data_ptr() if tensor_lr else None,
        0.0 if tensor_lr else float(lr), b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
        int(bool(clip)), _stream(device))
    _raise(err, "adamw_step")
    launches += len(params)
