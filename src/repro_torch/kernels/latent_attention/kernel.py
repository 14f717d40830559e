"""Hopper latent attention (B6): ctypes wrapper over ``csrc/latent_attention.cu``.

Multi-head latent attention's absorbed form (DeepSeek-V2) against the
latent cache: the queries folded into latent space, ``q_lat`` ``(B, S, N,
R)`` and ``q_rope`` ``(B, S, N, Rr)``, attend over one layer's ``ckv``
``(B, T, R)`` and ``krope`` ``(B, T, Rr)`` (strided views of the ``(L, B,
T, ·)`` cache, read through their strides), read in their stored dtype with
float32 logits, softmax and sums; the context ``(B, S, N, R)`` in the
inputs' dtype.  It replaces no TPU kernel: the JAX package computes this in
jnp (``src/repro/models/mla.py:114-127``), which the port's plain version,
:func:`.ref.latent_attention_ref`, repeats step by step with a float32 copy
of the cache and the scores in memory.  Every served DeepSeek-V2 step runs
it: the decode step and the prompt pass (``models/mla.py``).

Routing.  CPU and meta tensors take the plain version through
:func:`repro_torch.kernels.run_plain` (the dry run counts it as one
launch); CUDA tensors launch the kernel or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`: the sharded path
reaches B6 on each device's heads through ``on_local_shards``); an input
that needs a gradient is refused (the absorbed form serves only, under
``no_grad``).  The checks of the inputs, and the kernel's own limits (R up
to 512 and Rr up to 64, each a multiple of 16; float32 or bf16; the grid,
the split and shared memory: :func:`choose_launch` and
:func:`check_launch`), run before the routing, so they refuse on CPU
tensors too.

The plan (:func:`choose_launch`, plain Python) depends on shapes only,
never on the positions or ``kv_len``, which the kernel reads on the
device: a captured CUDA graph stays valid as the offsets advance.  bf16
runs on the tensor cores (``wgmma``) in CTAs of 64 query rows and 256
threads, two warpgroups and no producer warp: the cache comes in pairs of
64-position tiles, one TMA-fed buffer each, warpgroup 0 scoring the even
tile of a pair and warpgroup 1 the odd (:func:`tile_pairs`), each owning
half of the output's columns, one's softmax under the other's products
(FlashMLA's "seesaw" order; ``csrc/latent_attention.cu``'s note says what
bounds it).  The row tiles run from the last (:func:`row_tile`): a prompt
pass's heaviest first.  The positions split over CTAs in chunks of whole
pairs where the row tiles alone would leave the card idle; a split's
float32 partials are weighed by a second kernel.  float32 runs on the FMA
units (no TF32), 16 rows a CTA, no split.  A tensor whose last dimension is
not contiguous, or whose base or strides are off 16 bytes, is copied once
here and counted in ``layout_copies`` (0 on the served paths).

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture; a graph replay runs it again
without passing through here.  A call is one kernel, or two with a split
(``Launch.kernels``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import needs_grad, readable, run_plain, takes_plain

from .ref import latent_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "latent_attention.cu"
RANKS = tuple(range(16, 513, 16))     # latent widths R the kernel takes
ROPES = (16, 32, 48, 64)              # rope widths Rr
ROWS = {"bfloat16": 64, "float32": 16}   # query rows a CTA (csrc MT, FR)
TILE = 64                             # bf16: key positions a tile (csrc TK)
BOX = 64                              # bf16 columns of one 128-byte swizzle row
THREADS = 256                         # bf16: two warpgroups a CTA (csrc THREADS)
BUFFERS = 2                           # bf16: the buffers of a pair of tiles (csrc STAGES)
MAX_SPLIT = 256                       # csrc MAX_SPLIT: the combine's weights
SMS = 132                             # an H100 SXM's streaming multiprocessors
MAX_SMEM = 232448                     # a CTA's largest dynamic shared memory (227 KB)
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65535
MAX_POSITIONS = 2**31 - 1             # the kernel counts positions in int

launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()
_STRIDES = ctypes.c_longlong * 13     # q_lat 3, q_rope 3, ckv 2, krope 2, out 3


@dataclass(frozen=True)
class Launch:
    """What the kernel takes for one call: the positions in ``split``
    chunks of ``chunk`` (the last may be shorter), dynamic ``smem_bytes``.
    The rest follows from the shapes and the dtype."""

    dtype: str
    split: int
    chunk: int
    smem_bytes: int

    @property
    def rows(self) -> int:
        """Query rows a CTA."""
        return ROWS[self.dtype]

    @property
    def kernels(self) -> int:
        """Kernels a call: the attention, then with a split the combine."""
        return 1 + (self.split > 1)

    def grid(self, B: int, S: int, N: int) -> tuple[int, int, int]:
        """One CTA a (row tile of each batch row's S·N (token, head) rows,
        chunk, batch row), as the C entry launches it."""
        return (-(-S * N // self.rows), self.split, B)


def padded(R: int) -> int:
    """The bf16 kernel's latent width: R rounded up to 128 (csrc NCH)."""
    return 128 * -(-R // 128)


def smem_bytes(dtype: str, R: int, Rr: int) -> int:
    """Dynamic shared memory of a CTA (csrc ``layout_bf16``,
    ``f32_smem_bytes``).  bf16: the 64-row Q tile and ``BUFFERS`` buffers of
    one 64-position tile, each 2·RP/64 + 1 boxes of 128-byte rows (the
    latent padded to RP, one rope box, which a tile's P overwrites once its
    scores are done), the row exchange between the warpgroups (six rows of
    64 floats: each buffer's tile's max and rescale, each warpgroup's row
    sums), three mbarriers a buffer (its two groups of boxes landed; its
    tile's max, rescale and P published) and the CTA's limit.
    float32: the Q rows, one K tile of 32 padded rows, P, the rescale
    factors and the limit."""
    if dtype == "bfloat16":
        boxes = 2 * padded(R) // 128 + 1
        return boxes * 128 * (ROWS[dtype] + BUFFERS * TILE) + 6 * 64 * 4 + 8 * 3 * BUFFERS + 16
    D = R + Rr
    return 4 * (16 * D + 32 * (D + 1) + 16 * 32 + 16) + 16


def tile_pairs(tiles: int) -> list[tuple[int, int | None]]:
    """The bf16 kernel's schedule over a chunk of ``tiles`` 64-position
    tiles: pairs in order, the first of each scored by warpgroup 0 into
    buffer 0, the second by warpgroup 1 into buffer 1; a chunk with an odd
    number gives its last tile to warpgroup 0 alone (None: warpgroup 1
    scores nothing, and only multiplies warpgroup 0's P into its half)."""
    return [(i, i + 1 if i + 1 < tiles else None) for i in range(0, tiles, 2)]


def row_tile(x: int, row_tiles: int) -> int:
    """The row tile the bf16 CTA at ``blockIdx.x = x`` takes: from the
    last, so a prompt pass's last tokens, which see the most tiles, start
    first and the shortest fill the wave's tail (csrc ``rt``)."""
    return row_tiles - 1 - x


def check_launch(launch: Launch, B: int, S: int, N: int, T: int, R: int, Rr: int) -> Launch:
    """``launch`` if the kernel can run it for these shapes, else
    ``ValueError``: the grid within the launch limits, chunks that each
    start inside the cache and together cover it (whole tiles for bf16,
    whole pairs with a split; one for float32), at most ``MAX_SPLIT`` of
    them, and shared memory as :func:`smem_bytes` sizes
    it and within ``MAX_SMEM``.  The C entry checks the same limits
    again."""
    bf16 = launch.dtype == "bfloat16"
    grid = launch.grid(B, S, N)
    if grid[0] > MAX_GRID_X or max(grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"latent_attention: grid {grid} exceeds the launch limits")
    if not 1 <= launch.split <= (MAX_SPLIT if bf16 else 1):
        raise ValueError(f"latent_attention: a split of {launch.split} is outside 1.."
                         f"{MAX_SPLIT if bf16 else 1} for {launch.dtype}")
    if (launch.chunk < 1 or (bf16 and launch.chunk % (TILE * (1 + (launch.split > 1))))
            or not (launch.split - 1) * launch.chunk < T <= launch.split * launch.chunk):
        raise ValueError(f"latent_attention: {launch.split} chunks of {launch.chunk} positions "
                         f"do not each start inside T {T} and cover it")
    want = smem_bytes(launch.dtype, R, Rr)
    if launch.smem_bytes != want or want > MAX_SMEM:
        raise ValueError(f"latent_attention: shared memory {launch.smem_bytes} (the layout "
                         f"takes {want}; a CTA has {MAX_SMEM})")
    return launch


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, S: int, N: int, T: int, R: int, Rr: int, dtype: str) -> Launch:
    """The launch for ``B`` batch rows of ``S`` tokens and ``N`` heads over
    ``T`` cached positions, latent width ``R``, rope width ``Rr``, ``dtype``
    ("float32" or "bfloat16").  Plain Python, a function of these shapes
    alone.  bf16 takes 64 rows a CTA and a pair of tile buffers; when the
    row tiles (B x S·N / 64) leave SMs idle, the positions split into
    chunks of whole pairs (:func:`tile_pairs`: a pair is one round of the
    two warpgroups), as many as fill the card's ``SMS`` one CTA an SM, then
    as few as take the same pairs a chunk.  float32 takes 16 rows a CTA and
    no split.  Raises ``ValueError`` on a width or dtype the library lacks,
    an empty shape, or a launch :func:`check_launch` refuses."""
    if R not in RANKS or Rr not in ROPES:
        raise ValueError(f"latent_attention: R {R} and Rr {Rr} must be multiples of 16, R "
                         f"at most 512 and Rr at most 64")
    if dtype not in ROWS:
        raise ValueError(f"latent_attention takes float32 or bfloat16, not {dtype}")
    if min(B, S, N, T) < 1:
        raise ValueError(f"latent_attention: empty shape B {B} S {S} N {N} T {T}")
    if T > MAX_POSITIONS:
        raise ValueError(f"latent_attention: {T} positions exceed {MAX_POSITIONS}")
    if dtype == "float32":
        return check_launch(Launch(dtype, 1, T, smem_bytes(dtype, R, Rr)), B, S, N, T, R, Rr)
    tiles = -(-T // TILE)
    pairs = -(-tiles // 2)
    row_tiles = -(-S * N // ROWS[dtype])
    split = max(1, min(pairs, SMS // (B * row_tiles), MAX_SPLIT))
    chunk_pairs = -(-pairs // split)
    split = -(-pairs // chunk_pairs)
    chunk = TILE * (2 * chunk_pairs if split > 1 else tiles)
    launch = Launch(dtype, split, chunk, smem_bytes(dtype, R, Rr))
    return check_launch(launch, B, S, N, T, R, Rr)


def launch_for(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor) -> Launch:
    """The launch :func:`latent_attention` makes for these tensors."""
    B, S, N, R = q_lat.shape
    return choose_launch(B, S, N, ckv.shape[1], R, q_rope.shape[-1], str(q_lat.dtype)[6:])


def prepare(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor as it is if the kernel reads it in place (B3's rule:
    the last dimension contiguous, the base and the other strides multiples
    of 16 bytes), else one fresh contiguous copy, counted in
    ``layout_copies``."""
    global layout_copies
    out = []
    for t in tensors:
        if not readable(t):
            t = t.clone(memory_format=torch.contiguous_format)
            layout_copies += 1
        out.append(t)
    return out


def _index(t: torch.Tensor) -> torch.Tensor:
    """``t`` as int64, the kernel's index type (a counted copy otherwise)."""
    global layout_copies
    if t.dtype == torch.int64:
        return t
    layout_copies += 1
    return t.to(torch.int64)


def _kernel(device: torch.device):
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.latent_attention_init.argtypes = []
        lib.latent_attention_init.restype = ctypes.c_int
        lib.latent_attention.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
        lib.latent_attention.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.latent_attention_init()
        if err != 0:
            raise RuntimeError(f"latent_attention_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def _check(q_lat, q_rope, ckv, krope, positions, kv_len, scale) -> None:
    """Raises ``ValueError`` on inputs neither version takes, whatever the
    device (``TypeError`` on a DTensor)."""
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv), ("krope", krope)):
        takes_plain(t)
        if t.dtype != q_lat.dtype:
            raise ValueError(f"latent_attention: the queries and the cache must share one "
                             f"dtype; {name} is {t.dtype}, q_lat {q_lat.dtype}")
        if t.device != q_lat.device:
            raise ValueError(f"latent_attention: {name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
    if q_lat.dim() != 4 or q_rope.dim() != 4 or q_rope.shape[:3] != q_lat.shape[:3]:
        raise ValueError(f"latent_attention: q_lat {tuple(q_lat.shape)} and q_rope "
                         f"{tuple(q_rope.shape)} must be (B, S, N, R) and (B, S, N, Rr)")
    B, S, N, R = q_lat.shape
    if (ckv.dim() != 3 or krope.dim() != 3 or ckv.shape[0] != B or ckv.shape[2] != R
            or krope.shape[:2] != ckv.shape[:2] or krope.shape[2] != q_rope.shape[3]):
        raise ValueError(f"latent_attention: ckv {tuple(ckv.shape)} and krope "
                         f"{tuple(krope.shape)} must be (B={B}, T, R={R}) and (B, T, "
                         f"Rr={q_rope.shape[3]})")
    if kv_len.shape not in ((), (B,)) or kv_len.is_floating_point():
        raise ValueError(f"latent_attention: kv_len must be integer, ({B},) or 0-d; got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")
    if positions.shape not in ((B, S), (S,)) or positions.is_floating_point():
        raise ValueError(f"latent_attention: positions must be integer, ({B}, {S}) or "
                         f"({S},); got {positions.dtype} {tuple(positions.shape)}")
    for name, t in (("kv_len", kv_len), ("positions", positions)):
        takes_plain(t)
        if t.device != q_lat.device:
            raise ValueError(f"latent_attention: {name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"latent_attention: scale {scale} must be finite and positive")


def _launch(q_lat, q_rope, ckv, krope, positions, kv_len, scale, launch):
    """The kernel on the card: a fresh contiguous ``(B, S, N, R)`` output."""
    global launches
    B, S, N, R = q_lat.shape
    q_lat, q_rope, ckv, krope = prepare(q_lat, q_rope, ckv, krope)
    positions, kv_len = _index(positions), _index(kv_len)
    dev = q_lat.device
    out = torch.empty(q_lat.shape, dtype=q_lat.dtype, device=dev)
    o_part = ml_part = None
    if launch.split > 1:
        prows = B * launch.grid(B, S, N)[0] * launch.rows
        o_part = torch.empty((launch.split, prows, R), dtype=torch.float32, device=dev)
        ml_part = torch.empty((launch.split, prows, 2), dtype=torch.float32, device=dev)
    strides = _STRIDES(*q_lat.stride()[:3], *q_rope.stride()[:3], *ckv.stride()[:2],
                       *krope.stride()[:2], *out.stride()[:3])
    lib = _kernel(dev)
    err = lib.latent_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(), out.data_ptr(),
        None if o_part is None else o_part.data_ptr(),
        None if ml_part is None else ml_part.data_ptr(),
        positions.data_ptr(), kv_len.data_ptr(), strides,
        positions.stride(0) if positions.dim() == 2 else 0, positions.stride(-1),
        kv_len.stride(0) if kv_len.dim() == 1 else 0,
        int(q_lat.dtype == torch.bfloat16), B, S, N, ckv.shape[1], R, q_rope.shape[-1],
        launch.rows, launch.split, launch.chunk, launch.smem_bytes,
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"latent_attention launch failed: error {err} ({launch})")
    launches += 1
    return out


def latent_attention(
    q_lat: torch.Tensor,          # (B, S, N, R), any strides
    q_rope: torch.Tensor,         # (B, S, N, Rr)
    ckv: torch.Tensor,            # (B, T, R): one layer's latent cache, any strides
    krope: torch.Tensor,          # (B, T, Rr)
    positions: torch.Tensor,      # (B, S) or (S,), int64
    kv_len: torch.Tensor,         # (B,) or 0-d, int64
    *,
    scale: float,
) -> torch.Tensor:
    """The absorbed form's context in latent space, ``(B, S, N, R)`` in the
    inputs' dtype: key t of slot b is visible to the query at
    ``positions[b, s]`` when ``t <= positions[b, s]`` and ``t < kv_len[b]``,
    as :func:`.ref.latent_attention_ref` computes it."""
    scale = float(scale)
    _check(q_lat, q_rope, ckv, krope, positions, kv_len, scale)
    launch = launch_for(q_lat, q_rope, ckv)
    if needs_grad(q_lat, q_rope, ckv, krope):
        raise ValueError("latent_attention has no gradient: call it under torch.no_grad() "
                         "or on tensors that do not require one")
    if takes_plain(q_lat):
        return run_plain(functools.partial(latent_attention_ref, scale=scale), q_lat, q_rope,
                         ckv, krope, positions, kv_len)
    return _launch(q_lat, q_rope, ckv, krope, positions, kv_len, scale, launch)
