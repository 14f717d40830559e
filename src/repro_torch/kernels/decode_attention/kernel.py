"""Hopper decode attention (B3): ctypes wrapper over ``csrc/decode_attention.cu``.

One decode step's grouped-query attention over a KV cache, the cache read
in its stored dtype with float32 scores, softmax and sums: the port's
counterpart of the native-dtype dots XLA emits for the JAX package's
``_sdpa_deferred`` (and the cache form of ``_sdpa``).  It replaces no TPU
kernel.  :func:`decode_attention` takes the model layout as the layers make
it: q ``(B, S, NH, hd)``, one layer's cache ``(B, T, NKV, hd)`` (a strided
view of the ``(L, B, T, NKV, hd)`` cache, read through its strides) and,
for the deferred form, the step's own keys and values ``(B, S, NKV, hd)``.
Its plain version is :func:`.ref.decode_attention_ref`.

:func:`decode_attention_partials` is the partials form, for a cache split
over positions across devices: one shard of the cache, whose row t holds
key position ``t_start + t``, gives each row's float32 output over this
shard's keys and the log-sum-exp of their scores, which
:func:`.ops.combine` weighs across the shards.  Same plan, same checks,
the same kernel; its plain version is
:func:`.ref.decode_attention_partials_ref`.

Routing.  CPU and meta tensors take the plain version through
:func:`repro_torch.kernels.run_plain` (the dry run counts it as one
launch); CUDA tensors launch the kernel or raise; a ``DTensor`` raises
``TypeError`` (:func:`repro_torch.kernels.takes_plain`); an input that
needs a gradient is refused (the kernel has no backward: decoding runs
under ``no_grad``).  The checks of the inputs are plain Python and run
before the routing, so they refuse on CPU tensors too; the kernel's own
limits (head dims 32, 64, 80 and 128, float32 or bf16, the grid, the
cluster, the stages and shared memory) are :func:`choose_launch`'s and
:func:`check_launch`'s, which the CPU tests call directly.

The plan (:func:`choose_launch`, plain Python) depends on shapes only,
never on ``kv_valid`` or the positions, which the kernel reads on the
device: a captured CUDA graph stays valid as the offsets advance, and a
synchronized step runs the same plan as the per-slot step.  The kernel
reads K/V through their strides (bf16 by TMA boxes over tensor maps,
float32 one bulk copy a row): a cache or new part whose rows are off 16
bytes, or whose last dimension is not contiguous, is copied once here and
counted in ``layout_copies`` (0 on the served paths).

``launches`` counts the calls that launched the kernel from Python, or
recorded it into a CUDA graph under capture (of either form;
``partials_launches`` those of the partials form alone); a graph replay runs it again
without passing through here.  Each launch is one kernel: a cluster of
CTAs per (batch row, kv head, row tile) over the positions, combined in
the cluster's distributed shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import needs_grad, readable, run_plain, takes_plain

from .ref import decode_attention_partials_ref, decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (32, 64, 80, 128)
ROWS = (2, 4, 8, 16)          # float32: query rows per CTA (csrc kInstances)
MMA_ROWS = 16                 # bf16: query rows per CTA, the products' M (csrc MMA_ROWS)
CONSUMERS = 128               # consumer threads (csrc CONSUMERS) ...
THREADS = CONSUMERS + 32      # ... and one producer warp
WARPS = CONSUMERS // 32
TILE = 64                     # key positions per K/V tile (csrc TK)
COLS = 8                      # float32: columns per thread in the product with v (csrc COLS)
STAGES = (3, 4)               # the K/V ring's depths (csrc MIN_STAGES, MAX_STAGES)
MAX_CLUSTER = 8               # CTAs of a cluster (the portable most)
LONG_TILES = 16               # tiles a rank streams from which bytes, not latency, set its time
BARS = 128                    # bytes of the ring's mbarriers (csrc BARS)
SMS = 132                     # an H100 SXM's streaming multiprocessors ...
GPC_SMS = (17,) * 6 + (15,) * 2   # ... by GPC, as the cluster scheduler fills them
SMEM_PER_SM = 233472          # an SM's shared memory (228 KB) ...
SMEM_RESERVED = 1024          # ... of which each resident CTA takes 1 KB more
MAX_SMEM = 232448             # a CTA's largest dynamic shared memory (227 KB)
MAX_THREADS_PER_SM = 2048
MAX_GRID_YZ = 65535
MAX_ROWS = 2**31 - 1          # a shard's last position: the kernel counts cache rows in int

launches = 0
partials_launches = 0
layout_copies = 0
_lib = None
_ready_devices: set[int] = set()
_STRIDES = ctypes.c_longlong * 18     # (batch, row, head) of q, k/v cache, k/v new, out


@dataclass(frozen=True)
class Launch:
    """One launch: ``rows`` query rows per CTA in ``row_tiles`` tiles; a
    cluster of ``cluster`` CTAs per (batch row, kv head, row tile) splits
    the ``span`` cache positions a row tile can see (T, or under a window
    its reach, counted from the earliest row's window start), rank r taking
    ``[r·chunk, (r+1)·chunk)`` of them and, when ``new_rank`` is r, the
    step's own keys after them; a ring of ``stages`` K/V tiles; the
    ``grid`` (cluster, B·NKV, row tiles) of ``THREADS`` threads and dynamic
    ``smem_bytes``."""

    dtype: str
    head_dim: int
    rows: int
    row_tiles: int
    cluster: int
    span: int
    chunk: int
    stages: int
    new_rank: int | None
    grid: tuple[int, int, int]
    smem_bytes: int


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def k_pitch(head_dim: int) -> int:
    """float32: elements of one K tile row in shared memory (csrc
    ``k_pitch``), the head dim padded to 32 bytes past a multiple of 128."""
    nbytes = head_dim * 4
    return (nbytes + (32 - nbytes) % 128) // 4


def stage_bytes(head_dim: int, esize: int) -> int:
    """One stage of the ring, a K and a V tile of ``TILE`` rows.  bf16:
    TMA boxes of one swizzle row (64 columns, 32 at hd 32; hd 80 padded to
    128); float32: rows of ``k_pitch`` and ``head_dim`` elements."""
    if esize == 2:
        cols = min(head_dim, 64)
        hdp = 128 if head_dim == 80 else head_dim
        return 2 * (hdp // cols) * TILE * 2 * cols
    return TILE * (k_pitch(head_dim) + head_dim) * 4


def smem_bytes(rows: int, head_dim: int, esize: int, stages: int) -> int:
    """Dynamic shared memory of a CTA (csrc ``layout``): the larger of the
    ring of ``stages`` K/V tiles and what the end of a chunk keeps in its
    place (the scratch of the warps' states (bf16) or of the threads'
    slices (float32), the part the other ranks read and the combine's
    weights), then the mbarriers and, for float32, the query positions,
    rows and scores and the rescale factors."""
    scratch = (WARPS * MMA_ROWS * (head_dim + 2) * 4 + MMA_ROWS * WARPS * 4 if esize == 2
               else CONSUMERS * rows * COLS * 4)
    part = _align(scratch, 16)
    weights = _align(part + rows * (head_dim + 2) * 4, 16)
    end = weights + rows * (MAX_CLUSTER + 1) * 4
    total = _align(max(stages * stage_bytes(head_dim, esize), end), 128) + BARS
    if esize == 4:
        total += 8 * rows + 4 * rows * head_dim + 4 * rows * TILE + 16 * -(-4 * rows // 16)
    return total


def per_sm(smem: int) -> int:
    """CTAs of ``smem`` bytes an SM holds, by shared memory and threads."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // THREADS)


def resident_clusters(cluster: int, ctas_per_sm: int) -> int:
    """Clusters of ``cluster`` CTAs the card holds at once, ``ctas_per_sm``
    to an SM: a cluster lies in one GPC (``GPC_SMS``).  This model gives the
    132, 62, 30 and 14 clusters of 2, 4, 8 and 16 CTAs at two CTAs an SM
    that ``cudaOccupancyMaxActiveClusters`` gave on an H100 SXM (phase 3b
    of ``chip_smoke.py`` prints the card's for every plan)."""
    return sum(n * ctas_per_sm // cluster for n in GPC_SMS)


def check_launch(launch: Launch, B: int, T: int, NKV: int, new: bool) -> Launch:
    """``launch`` if the kernel can run it for these shapes, else
    ``ValueError``: the grid within the launch limits and one whole
    cluster along x, a cluster of at most ``MAX_CLUSTER`` CTAs whose ranks
    each cover part of the span (at most ``T``) and together all of it, a
    ring depth of
    ``STAGES``, shared memory as :func:`smem_bytes` sizes it and within
    ``MAX_SMEM``, and the step's own keys, if any, on the last rank."""
    grid, c = launch.grid, launch.cluster
    if not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f"decode_attention: a cluster of {c} CTAs is outside 1..{MAX_CLUSTER}")
    if grid[0] != c:
        raise ValueError(f"decode_attention: grid x {grid[0]} is not one cluster of {c}")
    if grid[1:] != (B * NKV, launch.row_tiles):
        raise ValueError(f"decode_attention: grid {grid} does not cover B·NKV {B * NKV} and "
                         f"{launch.row_tiles} row tiles")
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"decode_attention: B·NKV {grid[1]} or row tiles {grid[2]} exceeds "
                         f"the launch grid's {MAX_GRID_YZ}")
    if (launch.chunk < 1 or launch.span > T
            or not launch.chunk * (c - 1) < launch.span <= launch.chunk * c):
        raise ValueError(f"decode_attention: {c} ranks of {launch.chunk} positions do not "
                         f"each cover part of the span {launch.span} (T {T})")
    if launch.stages not in STAGES:
        raise ValueError(f"decode_attention: {launch.stages} stages, not one of {STAGES}")
    esize = 2 if launch.dtype == "bfloat16" else 4
    want = smem_bytes(launch.rows, launch.head_dim, esize, launch.stages)
    if launch.smem_bytes != want or want > MAX_SMEM:
        raise ValueError(f"decode_attention: shared memory {launch.smem_bytes} (the layout "
                         f"takes {want}; a CTA has {MAX_SMEM})")
    if launch.new_rank != (c - 1 if new else None):
        raise ValueError(f"decode_attention: the step's own keys on rank {launch.new_rank}, "
                         f"want {c - 1 if new else None}")
    return launch


@functools.lru_cache(maxsize=256)
def choose_launch(B: int, T: int, NKV: int, GS: int, head_dim: int, dtype: str,
                  new: bool, window: int | None = None) -> Launch:
    """The launch for ``B`` rows over a cache of ``T`` positions and
    ``NKV`` kv heads, ``GS`` = G·S query rows per kv head, ``head_dim``,
    ``dtype`` ("float32" or "bfloat16"), with or without the step's own
    keys (``new``), under a sliding ``window`` or none.  Plain Python, a
    function of these shapes alone.  The ring takes 3 or 4 stages, the
    depth that keeps more stages in flight on an SM by shared memory (4 of
    equals).  The ranks split the span a row tile sees (``T``; under a
    window at most ``window + GS`` positions) into chunks of whole
    64-position tiles, as many ranks (1 to ``MAX_CLUSTER``) as keep every
    (row, kv head, row tile) pair's cluster resident at once
    (:func:`resident_clusters`) and, when a rank would stream
    ``LONG_TILES`` or more (the bytes bound it), give the card at most one
    CTA an SM: a second only takes issue slots from the first.  Shorter
    chunks are bound by latency and take as many ranks as fit.  The step's
    own keys go to the last rank.  Raises
    ``ValueError`` on a head dim or dtype the library lacks, an empty
    shape, or a launch :func:`check_launch` refuses."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"decode_attention takes float32 or bfloat16, not {dtype}")
    if min(B, T, NKV, GS) < 1:
        raise ValueError(f"decode_attention: empty shape B {B} T {T} NKV {NKV} G·S {GS}")
    esize = 2 if dtype == "bfloat16" else 4
    rows = MMA_ROWS if esize == 2 else next((r for r in ROWS if r >= GS), ROWS[-1])
    row_tiles = -(-GS // rows)
    sizes = [(s, smem_bytes(rows, head_dim, esize, s)) for s in STAGES]
    stages, smem = max(sizes, key=lambda o: (o[1] <= MAX_SMEM, o[0] * per_sm(o[1]), o[0]))
    fit = max(1, per_sm(smem))
    pairs = B * NKV * row_tiles
    span = T if window is None else min(T, window + GS)
    tiles = -(-span // TILE)

    def ranks(split: int) -> int:
        return -(-tiles // -(-tiles // split))

    splits = [n for n in range(1, min(tiles, MAX_CLUSTER) + 1)
              if pairs <= resident_clusters(ranks(n), fit)] or [1]
    split = max([n for n in splits if pairs * ranks(n) <= SMS] or [1])
    if -(-tiles // split) < LONG_TILES:
        split = max(splits)
    cluster, chunk = ranks(split), TILE * -(-tiles // split)
    launch = Launch(dtype, head_dim, rows, row_tiles, cluster, span, chunk, stages,
                    cluster - 1 if new else None, (cluster, B * NKV, row_tiles), smem)
    return check_launch(launch, B, T, NKV, new)


def launch_for(q: torch.Tensor, k_cache: torch.Tensor, new: bool,
               window: int | None = None) -> Launch:
    """The launch :func:`decode_attention` makes for these tensors."""
    B, S, NH, hd = q.shape
    T, NKV = k_cache.shape[1], k_cache.shape[2]
    return choose_launch(B, T, NKV, NH // NKV * S, hd, str(q.dtype)[6:], new, window)


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


def _kernel(device: torch.device):
    global _lib
    if _lib is None:
        from repro_torch.kernels import build

        lib = build.load(SOURCE)
        lib.decode_attention_init.argtypes = []
        lib.decode_attention_init.restype = ctypes.c_int
        lib.decode_attention.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 12 + [ctypes.c_float] * 2
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_partials.argtypes = lib.decode_attention.argtypes + [
            ctypes.c_void_p, ctypes.c_longlong]
        lib.decode_attention_partials.restype = ctypes.c_int
        lib.decode_attention_max_clusters.argtypes = [ctypes.c_int] * 5
        lib.decode_attention_max_clusters.restype = ctypes.c_int
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            err = _lib.decode_attention_init()
        if err != 0:
            raise RuntimeError(f"decode_attention_init failed: CUDA error {err}")
        _ready_devices.add(index)
    return _lib


def max_active_clusters(launch: Launch, device: torch.device | None = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``launch``'s kernel, cluster
    and shared memory: the clusters the card holds at once (on the card)."""
    lib = _kernel(device or torch.device("cuda"))
    return lib.decode_attention_max_clusters(int(launch.dtype == "bfloat16"), launch.rows,
                                             launch.head_dim, launch.cluster, launch.smem_bytes)


def _check(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, scale, softcap,
           window, causal) -> None:
    """Raises ``ValueError`` on inputs neither version takes, whatever the
    device (``TypeError`` on a DTensor).  The kernel's own limits (head
    dim, dtype, grid, cluster, shared memory) are :func:`choose_launch`'s,
    on the card's route."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_new", k_new), ("v_new", v_new)):
        if t is None:
            continue
        takes_plain(t)
        if t.dim() != 4 or t.shape[-1] != q.shape[-1]:
            raise ValueError(f"decode_attention: {name} must be 4-d with head_dim "
                             f"{q.shape[-1]}; got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: q, the cache and the new part must share "
                             f"one dtype; {name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {q.device}")
    B, S, NH, hd = q.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B:
        raise ValueError(f"decode_attention: k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} must both be (B={B}, T, NKV, hd)")
    NKV = k_cache.shape[2]
    if min(S, k_cache.shape[1], NKV) < 1 or NH % NKV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} over a cache "
                         f"{tuple(k_cache.shape)}: need S, T >= 1 and NKV dividing NH")
    if (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: give both k_new and v_new, or neither")
    if k_new is not None:
        if k_new.shape != (B, S, NKV, hd) or v_new.shape != k_new.shape:
            raise ValueError(f"decode_attention: k_new {tuple(k_new.shape)} and v_new "
                             f"{tuple(v_new.shape)} must be {(B, S, NKV, hd)}")
        if not causal:
            raise ValueError("decode_attention: the deferred form (k_new, v_new) is causal")
    if kv_valid.shape not in ((), (B,)) or kv_valid.is_floating_point():
        raise ValueError(f"decode_attention: kv_valid must be integer, (B,) or 0-d; got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}")
    if positions.shape not in ((B, S), (S,)) or positions.is_floating_point():
        raise ValueError(f"decode_attention: positions must be integer, ({B}, {S}) or "
                         f"({S},); got {positions.dtype} {tuple(positions.shape)}")
    for name, t in (("kv_valid", kv_valid), ("positions", positions)):
        takes_plain(t)
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {q.device}")
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"decode_attention: scale {scale} must be finite and positive")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"decode_attention: softcap {softcap} must be finite and >= 0")
    if window is not None and not (isinstance(window, int) and 0 < window < 2**62):
        raise ValueError(f"decode_attention: window {window!r} must be None or a "
                         "positive int")


def _check_shard(t_start, T: int) -> None:
    """Raises ``ValueError`` unless ``t_start`` is an int >= 0 and the
    shard's positions ``t_start .. t_start + T - 1`` lie within ``MAX_ROWS``."""
    if isinstance(t_start, bool) or not isinstance(t_start, int) or t_start < 0:
        raise ValueError(f"decode_attention_partials: t_start {t_start!r} must be an int >= 0")
    if t_start + T > MAX_ROWS:
        raise ValueError(f"decode_attention_partials: a shard of {T} positions from {t_start} "
                         f"ends past {MAX_ROWS}")


def _plain(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, **kw):
    return decode_attention_ref(q, k_cache, v_cache, k_new, v_new, positions=positions,
                                kv_valid=kv_valid, **kw)


def _plain_partials(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, **kw):
    return decode_attention_partials_ref(q, k_cache, v_cache, k_new, v_new,
                                         positions=positions, kv_valid=kv_valid, **kw)


def _index(t: torch.Tensor) -> torch.Tensor:
    """``t`` as int64, the kernel's index type (a counted copy otherwise)."""
    global layout_copies
    if t.dtype == torch.int64:
        return t
    layout_copies += 1
    return t.to(torch.int64)


def _launch(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, scale, softcap,
            window, causal, t_start=None):
    """The kernel on the card: the output in q's dtype, or with ``t_start``
    the partials form's float32 ``(out, lse)``."""
    global launches, partials_launches, layout_copies
    B, S, NH, hd = q.shape
    new = k_new is not None
    if q.stride(-1) != 1:                 # q is read element by element
        q = q.contiguous()
        layout_copies += 1
    k_cache, v_cache = prepare(k_cache, v_cache)
    if new:
        k_new, v_new = prepare(k_new, v_new)
    positions, kv_valid = _index(positions), _index(kv_valid)
    launch = launch_for(q, k_cache, new, window)
    partial = t_start is not None
    out = torch.empty(q.shape, dtype=torch.float32 if partial else q.dtype, device=q.device)
    parts = (q, k_cache, v_cache, k_new if new else k_cache, v_new if new else v_cache, out)
    strides = _STRIDES(*(st for t in parts for st in t.stride()[:3]))
    lib = _kernel(q.device)
    args = (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr() if new else None, v_new.data_ptr() if new else None,
        out.data_ptr(), positions.data_ptr(), kv_valid.data_ptr(), strides,
        positions.stride(0) if positions.dim() == 2 else 0, positions.stride(-1),
        kv_valid.stride(0) if kv_valid.dim() == 1 else 0,
        int(q.dtype == torch.bfloat16), B, S, k_cache.shape[2], NH // k_cache.shape[2],
        k_cache.shape[1], hd, launch.rows, launch.cluster, launch.chunk, launch.stages,
        -1 if launch.new_rank is None else launch.new_rank,
        float(scale), float(softcap), int(window or 0), int(bool(causal)), launch.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if partial:
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        err = lib.decode_attention_partials(*args, lse.data_ptr(), t_start)
    else:
        err = lib.decode_attention(*args)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: error {err} ({launch})")
    launches += 1
    if partial:
        partials_launches += 1
        return out, lse
    return out


def decode_attention(
    q: torch.Tensor,                  # (B, S, NH, hd)
    k_cache: torch.Tensor,            # (B, T, NKV, hd), any strides
    v_cache: torch.Tensor,            # (B, T, NKV, hd)
    k_new: torch.Tensor | None = None,   # (B, S, NKV, hd): the deferred form
    v_new: torch.Tensor | None = None,
    *,
    positions: torch.Tensor,          # (B, S) or (S,)
    kv_valid: torch.Tensor,           # (B,) or 0-d
    scale: float | None = None,
    softcap: float = 0.0,
    window: int | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """One decode step's attention, ``(B, S, NH, hd)`` in q's dtype (a
    fresh contiguous tensor on the card): with ``k_new``/``v_new`` over the
    cache's first ``kv_valid[b]`` positions and the step's own keys at
    ``kv_valid[b] + j``, softmaxed together; without them over the cache's
    first ``kv_valid[b]`` positions, which already hold the step's keys.
    Masks by causality on ``positions``, by ``window`` and soft-caps the
    scores at ``softcap``, as :func:`.ref.decode_attention_ref` does."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, scale, softcap, window,
           causal)
    if needs_grad(q, k_cache, v_cache, k_new, v_new):
        raise ValueError("decode_attention has no gradient: call it under torch.no_grad() "
                         "or on tensors that do not require one")
    kw = dict(scale=scale, softcap=softcap, window=window, causal=causal)
    if takes_plain(q):
        return run_plain(functools.partial(_plain, **kw), q, k_cache, v_cache, k_new, v_new,
                         positions, kv_valid)
    return _launch(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, **kw)


def decode_attention_partials(
    q: torch.Tensor,                  # (B, S, NH, hd)
    k_cache: torch.Tensor,            # (B, T, NKV, hd): one shard, any strides
    v_cache: torch.Tensor,            # (B, T, NKV, hd)
    k_new: torch.Tensor | None = None,   # (B, S, NKV, hd): on the shard that counts them
    v_new: torch.Tensor | None = None,
    *,
    positions: torch.Tensor,          # (B, S) or (S,), global
    kv_valid: torch.Tensor,           # (B,) or 0-d, global
    t_start: int,                     # the global position of the shard's first row
    scale: float | None = None,
    softcap: float = 0.0,
    window: int | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's part of a decode step's attention: ``(out, lse)``, out
    ``(B, S, NH, hd)`` float32 over the keys this shard holds (cache row t
    at position ``t_start + t``, and the step's own keys if given), lse
    ``(B, S, NH)`` float32, the log-sum-exp of their scores; the masks as
    :func:`decode_attention`'s, in global positions.  :func:`.ops.combine`
    weighs the shards' parts into the output."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, scale, softcap, window,
           causal)
    _check_shard(t_start, k_cache.shape[1])
    if needs_grad(q, k_cache, v_cache, k_new, v_new):
        raise ValueError("decode_attention_partials has no gradient: call it under "
                         "torch.no_grad() or on tensors that do not require one")
    kw = dict(scale=scale, softcap=softcap, window=window, causal=causal)
    if takes_plain(q):
        return run_plain(functools.partial(_plain_partials, t_start=t_start, **kw), q, k_cache,
                         v_cache, k_new, v_new, positions, kv_valid)
    return _launch(q, k_cache, v_cache, k_new, v_new, positions, kv_valid, t_start=t_start,
                   **kw)
