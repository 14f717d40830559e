"""Hopper cross-entropy on a vocabulary shard (B5): ctypes wrapper over
``csrc/cross_entropy.cu``.

The token loss of a training step: XLA's fusion of the JAX package's
``training/train_lib.py:22-31`` inside the jitted step, not a TPU kernel.
Two functions, each one kernel launch:

* :func:`ce_partials`: each row's max ``m``, ``s = sum(exp(x - m))`` and
  the label's logit over one shard of the vocabulary, the columns
  ``[start, start + width)``, reading each logit once;
* :func:`ce_backward`: ``g * (exp(x - lse) - onehot)`` on the shard,
  reading each logit once and writing its gradient once.

:mod:`.ops` combines the shards' partials into the loss.  The plain
versions are in :mod:`.ref`.

Routing.  CPU and meta tensors take the plain versions through
:func:`repro_torch.kernels.run_plain` (the dry run counts each as one
launch); CUDA tensors launch the kernels or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`): the loss passes
each device's local shard.  The checks are plain Python and run before the
routing: float32 logits ``(..., width)``, int64 labels of the logits'
leading shape, on one device, ``0 <= start`` and ``start + width <=
vocab``.  On the CPU a label at or past ``vocab`` raises; on the card the
kernel writes NaN for it (a check there would wait for the device, and a
CUDA graph cannot capture a wait), as JAX's gather fills one.

A non-contiguous input is copied once, and the copy is counted in
``layout_copies``.  The plan (:func:`choose_launch`) is a function of the
shape alone, so replays repeat bit for bit.  ``launches`` counts the
kernels launched from Python or recorded into a CUDA graph under capture;
an empty input launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import run_plain, takes_plain

from .ref import ce_backward_ref, ce_partials_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "cross_entropy.cu"
THREADS = 256                 # threads a block (csrc THREADS)
VEC = 16                      # bytes a vector load: a group of 4 float32 columns
MAX_ROWS = 2**31 - 1          # the grid's x limit: one block a row

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


@dataclass(frozen=True)
class Launch:
    """One call's plan: ``grid`` blocks of :data:`THREADS`, one a row (the
    kernel splits a row's columns among its threads itself)."""

    grid: int


@functools.lru_cache(maxsize=1024)
def choose_launch(rows: int, width: int) -> Launch:
    """The plan for ``rows`` rows of ``width`` columns: one block a row.
    Plain Python, a function of the shape alone."""
    if rows < 0 or width < 0:
        raise ValueError(f"cross_entropy: a shard of {rows} rows x {width} columns")
    if rows > MAX_ROWS:
        raise ValueError(f"cross_entropy: {rows} rows, more than the grid's {MAX_ROWS}")
    return Launch(grid=rows)


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous, else one contiguous copy, counted in
    ``layout_copies``."""
    global layout_copies
    if t.is_contiguous():
        return t
    layout_copies += 1
    return t.contiguous()


def _check(logits, labels, start: int, vocab: int) -> None:
    for what, t in (("logits", logits), ("labels", labels)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"cross_entropy: {what} is {type(t).__name__}, not a tensor")
        takes_plain(t)
    if logits.dtype != torch.float32:
        raise ValueError(f"cross_entropy: logits are {logits.dtype}; B5 takes float32 (unembed's "
                         "dtype)")
    if labels.dtype != torch.int64:
        raise ValueError(f"cross_entropy: labels are {labels.dtype}; B5 takes int64")
    if logits.dim() < 1 or tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"cross_entropy: labels {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"cross_entropy: labels on {labels.device}, logits on {logits.device}")
    width = logits.shape[-1]
    if not 0 <= start or start + width > vocab:
        raise ValueError(f"cross_entropy: columns [{start}, {start + width}) of a vocabulary of "
                         f"{vocab}")


def _kernel(device: torch.device):
    """The library, loaded once, its kernels loaded on ``device`` once (a
    CUDA graph capture then never loads one)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.ce_init.argtypes = []
        lib.ce_init.restype = ctypes.c_int
        lib.ce_threads.argtypes = []
        lib.ce_threads.restype = ctypes.c_int
        lib.ce_partials.argtypes = [_P, _P, _LL, _LL, _LL, _LL, ctypes.c_int, _P, _P]
        lib.ce_partials.restype = ctypes.c_int
        lib.ce_backward.argtypes = [_P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_int, _P, _P]
        lib.ce_backward.restype = ctypes.c_int
        if lib.ce_threads() != THREADS:
            raise RuntimeError(f"cross_entropy: the library's blocks have {lib.ce_threads()} "
                               f"threads, the wrapper plans for {THREADS}")
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            _raise(_lib.ce_init(), "ce_init")
        _ready_devices.add(index)
    return _lib


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _aligned(x: torch.Tensor) -> int:
    """Each row of ``x`` starts on 16 bytes: it is read in vectors."""
    return int(x.data_ptr() % VEC == 0 and x.shape[-1] % 4 == 0)


def ce_partials(logits: torch.Tensor, labels: torch.Tensor, start: int, vocab: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(m, s, gold)``, float32 of the labels' shape, over the shard
    ``logits`` (float32 ``(..., width)``) of the columns ``[start, start +
    width)`` of a vocabulary of ``vocab``: the shard's max, ``sum(exp(x -
    m))``, and the logit at the clamped label where the shard holds it
    (else 0)."""
    global launches
    _check(logits, labels, start, vocab)
    if labels.device.type == "cpu" and labels.numel():
        # read through numpy: no torch op, so the dry run's counter sees
        # the step a card runs
        top = int(labels.numpy().max())
        if top >= vocab:
            raise ValueError(f"cross_entropy: a label {top} out of range of a vocabulary of "
                             f"{vocab}")
    lead, width = labels.shape, logits.shape[-1]
    x = contiguous(logits).view(labels.numel(), width)
    lab = contiguous(labels).view(-1)
    if takes_plain(x):
        with torch.no_grad():
            m, s, gold = run_plain(ce_partials_ref, x, lab, start, vocab)
        return m.view(lead), s.view(lead), gold.view(lead)
    plan = choose_launch(x.shape[0], width)
    out = torch.empty(3, plan.grid, dtype=torch.float32, device=x.device)
    if not plan.grid:           # no rows: nothing to launch
        return out[0].view(lead), out[1].view(lead), out[2].view(lead)
    err = _kernel(x.device).ce_partials(x.data_ptr(), lab.data_ptr(), plan.grid, width, start,
                                        vocab, _aligned(x), out.data_ptr(), _stream(x.device))
    _raise(err, "ce_partials")
    launches += 1
    return out[0].view(lead), out[1].view(lead), out[2].view(lead)


def ce_backward(logits: torch.Tensor, labels: torch.Tensor, start: int, lse: torch.Tensor,
                g: torch.Tensor, vocab: int) -> torch.Tensor:
    """``g[..., None] * (exp(logits - lse[..., None]) - onehot)``, float32
    in the logits' shape: the gradient of each row's ``lse - gold`` over the
    shard, times ``g``; ``lse`` and ``g`` float32 of the labels' shape."""
    global launches
    _check(logits, labels, start, vocab)
    lead, width = labels.shape, logits.shape[-1]
    for what, t in (("lse", lse), ("g", g)):
        takes_plain(t)
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(lead) or t.device != logits.device:
            raise ValueError(f"cross_entropy: {what} must be float32 {tuple(lead)} on "
                             f"{logits.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    x = contiguous(logits).view(labels.numel(), width)
    lab = contiguous(labels).view(-1)
    lse1, g1 = contiguous(lse).view(-1), contiguous(g).view(-1)
    if takes_plain(x):
        with torch.no_grad():
            return run_plain(ce_backward_ref, x, lab, start, lse1, g1).view(logits.shape)
    plan = choose_launch(x.shape[0], width)
    dx = torch.empty_like(x)
    if not dx.numel():          # no rows or an empty shard: nothing to launch
        return dx.view(logits.shape)
    err = _kernel(x.device).ce_backward(x.data_ptr(), lab.data_ptr(), lse1.data_ptr(),
                                        g1.data_ptr(), plan.grid, width, start, _aligned(x),
                                        dx.data_ptr(), _stream(x.device))
    _raise(err, "ce_backward")
    launches += 1
    return dx.view(logits.shape)
