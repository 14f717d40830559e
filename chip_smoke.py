#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. device: name, count, power limit; TF32 off for float32 matmuls and
   convolutions;
2. build: compile both kernels (flash attention B1, stream_pack B2) for
   sm_90a, one nvcc for each source, both started together; print their
   ptxas register / shared-memory / spill reports;
3. kernel against its plain PyTorch version on the card over a sweep of
   dtypes, head dims (zamba2's 80 among them), GQA groups, lengths (ragged
   ones included), windows, soft-caps (with scores large enough for the cap
   to matter) and masks, each within atol + rtol*|ref|, launching every
   kernel of the library, at arctic-480b's GQA group 7 (56 over 8 heads,
   hd 128), and on the model layout at each shape, batch included, at
   which phases 11-14 call it (``family_shapes``: llava's prefill buckets
   and 2944 positions at GQA 7, seamless's bidirectional encoder and cross
   attention, Sq = 1 among them, zamba2's hd 80; after phase 14 the run
   fails if those phases called B1 at any other shape); model-layout
   inputs read through their strides (B=2, a head slice, a
   transposed (B,H,S,hd) storage, layouts that take one counted copy) and a
   captured call replayed on inputs changed in place; then times at
   phi4-mini's prefill buckets and S=2048, at arctic-480b's at S=512 and at
   the four families' shapes, in a CUDA graph and launched from Python,
   beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) and the card's bound;
4. serve: phi4-mini-3.8b at full width and depth, bf16, random weights made
   on the card from a seed, 8 requests through ``ServingEngine`` with
   CUDA-graph-sealed steps; checks the tokens and that prefill went
   through the kernel (the wrapper's count, and the profiler's count of
   flash kernels inside one prefill replay) with no layout copy;
5. the same code on the card and on the CPU (2 layers, float32, one set of
   weights): prefill logits within 1e-3 and identical greedy tokens;
6. stream_pack kernel against its plain PyTorch version on the card over
   lanes, shapes (the branchy cells', ragged ones, K or N off the 16-byte
   vector, K too deep for the float32 panel), dtypes, a shared or separate
   x, and x 4 bytes off a 16-byte boundary, each within atol + rtol*|ref|;
   every kernel of the library (each tile, each loader) must be launched;
   then times at the
   four branchy cells' shapes and one bf16 shape, with the variant and tile
   each took, each call inside a CUDA graph and launched from Python,
   beside the plain version, one ``torch.matmul`` over the broadcast x (a
   yardstick only: the port never calls it) and the card's bound; then the
   MoE expert GEMMs of arctic-480b and deepseek-v2-236b at full width, bf16,
   at every capacity the served path gives them (M 2-64), against the
   plain version (computed a few lanes at a time), and at the decode
   capacity (4) and prefill bucket 64's (64) timed beside ``torch.bmm``
   and the weights' bytes;
7. Nimble on the four branchy cells at full size, float32: plain eager
   PyTorch, ``EagerInterpreter``, ``Nimble`` on one stream, on Algorithm 1's
   streams (one CUDA graph over several CUDA streams) and packed onto
   stream_pack; checks each against eager, and each replay on another input
   and on other weights; prints the schedule's counts, the planned arena
   beside the graph pool's bytes, microseconds per call, the stream_pack
   kernels the profiler sees inside one packed replay (which must equal the
   packed mm groups) and their device time, and the streams it sees in one
   multi-stream replay; two packed replays must give the same bits; the
   ``JitPerOpEngine`` column (Fig. 7's TorchScript) within 1e-5 of eager;
8. serve: arctic-480b at full width and 2 of its 35 layers (about 55 GB of
   bf16 weights), random weights made on the card from a seed, 4 slots of
   1024 positions, buckets 64-512, 8 requests of 20-500 prompt tokens and 16
   new ones through ``ServingEngine`` with CUDA-graph-sealed steps; checks
   the tokens, the replays, the wrappers' counts, and that one decode
   replay and one prefill replay each ran 3 x n_layers B2 kernels (the
   expert GEMMs) and the prefill n_layers ``flash_fwd``; prints seal time,
   TTFT p50, decode tok/s, peak memory and the top device ops of each
   profiled replay with B2's share;
9. the same for deepseek-v2-236b (2 of 60 layers, MLA: no flash kernel);
10. arctic-smoke and deepseek-v2-smoke on the card and on the CPU at
    float32, one set of weights: identical greedy tokens;
11. llava-next-34b at full width and 4 of its 60 layers, bf16: served as
    phase 4 serves phi4-mini (text prompts), then one ``forward`` of 2880
    vision embeddings and 64 tokens (B1 at S = 2944, GQA 7);
12. seamless-m4t-medium at full width and depth, bf16: ``encode_memory``
    of 4 x 128 frames (B1 bidirectional), the teacher-forced ``forward``
    of 4 x 512 tokens, then 16 greedy steps of batch ``decode_step`` for 4
    sequences with the memory in the cache (cross attention on B1 with one
    query row), eagerly and as a captured CUDA graph: the same tokens;
13. zamba2-2.7b at full width and depth, bf16: ``forward`` of 4 x 512
    tokens (the chunked SSD; the shared block's attention on B1 at hd 80,
    9 times), then the batch decode of phase 12 from an empty state;
14. xlstm-125m at full width and depth, bf16: the same as phase 13 (the
    chunked mLSTM, sLSTM at layers 3, 7 and 11; no attention);
15. the smoke configs of llava-next, seamless, zamba2 and xlstm on the card
    and on the CPU at float32, one set of weights: ``forward`` logits within
    ``FAMILY_FORWARD_TOL`` and identical greedy tokens (llava through
    ``ServingEngine``, the others by batch decode);
16. the control plane in process: an ``AsyncDispatcher`` over two lanes,
    phi4-mini-3.8b at full width and depth (class 0, a latency target) and
    deepseek-v2-236b at full width and 2 layers (class 1), bf16, one shared
    schedule cache; a burst of 16 mixed requests under per-engine steppers,
    under a pool of two, and once more profiled (the profiler must see
    exactly the ``flash_fwd`` and ``stream_pack`` kernels the lanes'
    replays imply, up to three bursts; that session gives the device's
    busy share of the burst).  phi4-mini's tokens
    must equal the same engine's driven by ``run_until_drained``; the MoE
    lane's requests must complete with their token counts.  Then a third
    lane (phi4-mini smoke, float32, a schedule cache of one entry)
    registers while the two serve, capturing its CUDA graphs between their
    replays, and its first request re-seals an evicted bucket on its
    stepper: ``builds_on_thread`` must be 0 everywhere else.  The third
    lane's requests, served the same way on the CPU, give the same tokens;
17. the worker plane: ``stepping="workers"`` with one spawned worker on
    ``cuda:0`` building phi4-mini from ``ServingEngineSpec(smoke=False,
    dtype="bfloat16", seed=0)``; its tokens equal an in-process engine's
    built from the same spec; ``fork`` is refused (CUDA is initialised
    here); then the worker is SIGKILLed in the middle of a step: the
    requests in flight fail ``WorkerCrashed``, the queued ones replay on
    the respawned worker token-identically; prints spawn and respawn times;
18. journal and observability: a journaled run of that lane, stopped with
    work in flight, is recovered by a fresh dispatcher (the lane rebuilt
    from its journaled spec) and the unfinished requests replay
    token-identically; the recovered run's Chrome trace must validate, and
    a ``MetricsRegistry``'s Prometheus text must hold the dispatch, cache,
    worker-plane and tracer families.

Each phase prints its times (CUDA events, graph replays), the kernels of
one profiled call, and the wrappers' counts; each forward and each decode
must launch the flash kernel exactly as often as the model has attention
over a full sequence or a memory.

Each profiled graph replay has its outputs poisoned before it and must
give them back right, so a replay that ran nothing cannot pass as a
profiler that saw nothing.

The line before the last is the per-kernel JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate, float32
# without tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# (atol, rtol): the kernel passes where |got - ref| <= atol + rtol * |ref|.
# float32 differs from its plain version only by summation order; bf16 also
# by the rounding of p and of the output (one bf16 ulp is 2**-8 relative)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-2, 1e-2)}
# soft-cap cases scale q up so that scores reach about +-20 and the cap
# bends them; at unit scale a cap of 50 would move the output by ~1e-3
CAP_Q_SCALE = 8.0
# the served phases' prefill buckets and decode slots, and the lengths
# phase 3 times B1 at
PREFILL_BUCKETS = (64, 128, 256, 512)
SERVE_SLOTS = 4
TIMED_LENGTHS = PREFILL_BUCKETS + (2048,)


def ratio(got, ref, atol: float, rtol: float) -> float:
    """Largest ``|got - ref| / (atol + rtol * |ref|)``: within tolerance at <= 1."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def tol_ratio(got, ref, dname: str) -> float:
    """:func:`ratio` at flash attention's tolerance for ``dname``."""
    return ratio(got, ref, *TOL[dname])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back launches, on CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, reps: int = 20, iters: int = 50) -> float:
    """Mean time of one call of ``fn`` inside a CUDA graph of ``reps``
    back-to-back calls, replayed ``iters`` times: the device's time for the
    call without the host's cost of launching it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters) / reps


def phase_device():
    import torch

    say("== phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(f"device: {name} | count {count} | torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"nvidia-smi: {nvidia_smi()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name, count


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.stream_pack import kernel as pack

    say("== phase 2: build")
    sources = [flash.SOURCE, pack.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:      # one nvcc per source
        list(pool.map(build.build, sources))
    say(f"built {', '.join(build.library_path(s).name for s in sources)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for source in sources:
        build.load(source)
        say(f"  {source.name}:")
        for line in build.build_log(source).splitlines():
            if "ptxas" in line or "spill" in line:
                say(f"    {line.strip()}")


def _qkv(BH_kv, group, Sq, Skv, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((BH_kv * group, Sq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


# phase 3's (group, window, softcap, causal) combinations, run at every
# dtype, head dim and length
FLASH_COMBOS = [(1, 0, 0.0, True), (3, 0, 50.0, True), (4, 16, 0.0, True),
                (3, 100, 50.0, True), (1, 0, 0.0, False), (4, 16, 50.0, False),
                (3, 100, 0.0, False)]


def flash_cases() -> list[tuple[str, int, int, int, int, int, int, float, bool]]:
    """Phase 3's (dtype, hd, kv heads, group, Sq, Skv, window, softcap,
    causal) cases: 172 with 2 kv heads (every head dim, zamba2-2.7b's 80
    among them), then phi4-mini's 8 kv heads x group 3 at S=2048 for every
    head dim, a grid that fills the card (the 172 take the split tile at
    S=200 and 1024, the single one at S=64)."""
    cases = []
    for dname in ("float32", "bfloat16"):
        for hd in (32, 64, 80, 128):
            for S in (64, 200, 1024):
                for group, window, cap, causal in FLASH_COMBOS:
                    cases.append((dname, hd, 2, group, S, S, window, cap, causal))
        for causal in (True, False):                 # Sq != Skv
            cases.append((dname, 128, 2, 3, 64, 256, 0, 0.0, causal))
    for hd in (32, 64, 80, 128):
        cases.append(("bfloat16", hd, 8, 3, 2048, 2048, 0, 0.0, True))
        cases.append(("bfloat16", hd, 8, 3, 2048, 2000, 300, 50.0, False))
    return cases


def gqa7_cases() -> list[tuple[str, int, int, int, int, int, int, float, bool]]:
    """Phase 3's cases at arctic-480b's attention: 56 query heads over 8 kv
    heads (GQA group 7), hd 128, causal, at the smallest and largest prefill
    bucket, in both dtypes (same fields as :func:`flash_cases`)."""
    return [(dname, 128, 8, 7, S, S, 0, 0.0, True)
            for dname in ("bfloat16", "float32") for S in (64, 512)]


# the paths of phases 11-14 that launch B1; llava-next-34b's forward puts a
# prompt of VLM_PROMPT tokens after its vision embeddings
FAMILY_ARCHS = ("llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b")
VLM_PROMPT = 64


def path_attention_shapes(cfg, batch: int, length: int, prompt: int,
                          buckets) -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """B1's calls on the path of phases 11-14 for ``cfg``, as (label, B, q
    heads, kv heads, Sq, Skv, hd, causal): llava served (a one-request
    prefill at each of ``buckets``; its decode attention is plain) and a
    forward of its vision embeddings and ``prompt`` tokens; seamless's
    encoder over ``length // audio_frames_ratio`` frames, its decoder's self
    and cross attention in a forward of ``batch`` x ``length`` tokens, and
    the cross attention of a decode step (one query row); zamba2's shared
    block in a forward of ``batch`` x ``length`` tokens (its decode
    attention is plain); none for xLSTM."""
    H, KV, hd, name = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.name
    if cfg.family == "vlm":
        S = cfg.vision_tokens + prompt
        return [(f"{name} prefill {b}", 1, H, KV, b, b, hd, True) for b in buckets] + [
            (f"{name} vision prompt", 1, H, KV, S, S, hd, True)]
    if cfg.family == "audio":
        T = length // cfg.audio_frames_ratio
        return [(f"{name} encoder", batch, H, KV, T, T, hd, False),
                (f"{name} decoder prompt", batch, H, KV, length, length, hd, True),
                (f"{name} cross attention", batch, H, KV, length, T, hd, False),
                (f"{name} cross attention, decode", batch, H, KV, 1, T, hd, False)]
    if cfg.family == "hybrid":
        return [(f"{name} shared block", batch, H, KV, length, length, hd, True)]
    return []


def family_shapes() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """:func:`path_attention_shapes` of the full configs at the sizes phases
    11-14 drive them."""
    import repro_torch.configs as C

    return [shape for arch in FAMILY_ARCHS for shape in path_attention_shapes(
        C.get(arch), DECODE_BATCH, FORWARD_LEN, VLM_PROMPT, PREFILL_BUCKETS)]


def family_cases() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """Phase 3's model-layout cases at :func:`family_shapes`, in both
    dtypes, as (dtype, B, hd, kv heads, group, Sq, Skv, causal)."""
    return [(dname, B, hd, kv, q // kv, Sq, Skv, causal)
            for dname in ("bfloat16", "float32")
            for _, B, q, kv, Sq, Skv, hd, causal in family_shapes()]


def _flash_tile(q, k, v) -> str:
    from repro_torch.kernels.flash_attention import kernel

    launch = kernel.launch_for(q, k, v)
    return (f"tile {launch.rows} rows x {launch.keys} keys, {launch.warpgroups} consumer "
            f"warpgroup(s), {launch.threads} threads, grid {launch.grid}, smem "
            f"{launch.smem_bytes} B, TMA boxes q {launch.q_box} kv {launch.kv_box}")


def _bshd_qkv(B, kv_heads, group, Sq, Skv, hd, dtype, seed):
    """Contiguous model-layout q (B, Sq, heads, hd) and k, v (B, Skv,
    kv_heads, hd), as the models' projections give them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, n, hd), generator=g, device="cuda").to(dtype)
            for S, n in ((Sq, kv_heads * group), (Skv, kv_heads), (Skv, kv_heads))]


def _ref_bshd(q, k, v, group, **kw):
    """flash_attention_ref on model-layout (B, S, H, hd) tensors."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    B, Sq, NH, hd = q.shape
    flat = [t.transpose(1, 2).reshape(B * t.shape[2], t.shape[1], hd) for t in (q, k, v)]
    return flash_attention_ref(*flat, group=group, **kw).reshape(B, NH, Sq, hd).transpose(1, 2)


def phase_kernel() -> dict:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel

    say("== phase 3: flash_attention kernel vs plain version (tolerance "
        "|err| <= atol + rtol*|ref|: f32 1e-4 + 0 for summation order; bf16 "
        f"1e-2 + 1e-2*|ref| for bf16 rounding of p and output; soft-cap cases "
        f"scale q by {CAP_Q_SCALE:g} so the cap bends the scores)")
    # (batch, case): B1 on (BH, S, hd) for batch None, else on the model
    # layout (B, S, heads, hd) at the batch the family paths give it
    cases = [(None, c) for c in flash_cases() + gqa7_cases()] + [
        (B, (dname, hd, kv, group, Sq, Skv, 0, 0.0, causal))
        for dname, B, hd, kv, group, Sq, Skv, causal in family_cases()]
    worst, reached = 0.0, {}
    for i, (B, (dname, hd, kv_heads, group, Sq, Skv, window, cap, causal)) in enumerate(cases):
        dtype = getattr(torch, dname)
        if B is None:
            q, k, v = _qkv(kv_heads, group, Sq, Skv, hd, dtype, seed=i)
            run, plain = flash_attention, flash_attention_ref
        else:
            q, k, v = _bshd_qkv(B, kv_heads, group, Sq, Skv, hd, dtype, seed=i)
            run, plain = kernel.attention, _ref_bshd
        if cap:
            q = q * CAP_Q_SCALE                      # a power of 2: exact in bf16
        kw = dict(group=group, softcap=cap, causal=causal, window=window)
        launch = kernel.launch_for(q, k, v)
        got = run(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        reached[launch.instance] = reached.get(launch.instance, 0) + 1
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tol_ratio(got, ref, dname)
        ok = math.isfinite(err) and ratio <= 1.0
        note = ""
        if cap:
            # the cap must matter here, or this case cannot catch a kernel
            # that ignores it
            uncapped = plain(q, k, v, **{**kw, "softcap": 0.0})
            moved = (uncapped.float() - ref.float()).abs().max().item()
            note = f" | cap moves the output by {moved:.3e}"
            if not moved >= 10 * TOL[dname][0]:
                fail(f"soft-cap {cap} moves the output by only {moved}: the case is blind to it")
        say(f"  {dname:8s} B={B or 1} hd={hd:3d} heads={kv_heads * group:2d}/{kv_heads} "
            f"Sq={Sq:4d} Skv={Skv:4d} window={window:3d} softcap={cap:4.0f} "
            f"causal={int(causal)} wg={launch.warpgroups}: max_abs_err {err:.3e} ({ratio:.2f} "
            f"of tolerance) {'ok' if ok else 'FAIL'}{note}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {ratio:.3f} of tolerance {TOL[dname]}")
        worst = max(worst, ratio)
    say(f"  {len(cases)} cases within tolerance (worst at {worst:.2f} of its tolerance); "
        "cases by kernel (dtype, hd, consumer warpgroups, keys): "
        + ", ".join(f"{d} {hd} {w}x{kk} {n}" for (d, hd, w, kk), n in sorted(reached.items())))
    missing = set(kernel.INSTANCES) - set(reached)
    if missing:
        fail(f"phase 3 never launched the flash kernels {sorted(missing)}")
    flash_layouts()
    record = flash_timing(describe=_flash_tile)
    record["arctic_prefill"] = flash_timing(
        describe=_flash_tile, q_heads=56, lengths=(512,), model="arctic-480b")
    say("-- timing at the family paths' shapes (bf16; batch x heads as heads, which "
        "gives the same grid and tile)")
    record["family_shapes"] = {
        label: flash_time(B * q, B * kv, Sq, Skv, hd, causal, label, describe=_flash_tile)
        for label, B, q, kv, Sq, Skv, hd, causal in family_shapes()}
    return record


def flash_layouts() -> None:
    """Model-layout inputs read through their strides, held against the
    plain version: each must take exactly the expected number of counted
    layout copies.  Then a call captured in a CUDA graph, replayed after
    new values were written into its inputs in place."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, mha_flash

    say("-- model layout (B, S, H, hd) through strides: 24 q heads over 8 kv heads")
    B, S, NH, NKV = 2, 200, 24, 8
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def misaligned_rows(t):
        # the same values with a sequence stride 4 elements past the packed one
        B_, S_, H_, hd_ = t.shape
        row = H_ * hd_ + 4
        store = torch.zeros(B_ * S_ * row, dtype=t.dtype, device=t.device)
        view = store.as_strided(t.shape, (S_ * row, row, hd_, 1))
        view.copy_(t)
        return view

    def offset_base(t):
        # the same values one element past a 16-byte boundary
        store = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = store[1:].view(t.shape)
        view.copy_(t)
        return view

    layouts = {
        "contiguous (B,S,H,hd)": (lambda t: t, 0),
        "q a head slice of a wider tensor":
            (lambda t: torch.cat([t[:, :, :4], t, t[:, :, :4]], dim=2)[:, :, 4:4 + t.shape[2]], 0),
        "(B,H,S,hd) storage as a transposed view":
            (lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), 0),
        "sequence stride 8 bytes off 16 (bf16: one counted copy)": (misaligned_rows, 1),
        "base pointer off 16 bytes (bf16: one counted copy)": (offset_base, 1),
    }
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for hd in (64, 128):
            q0, k, v = randn(B, S, NH, hd, dtype=dtype), randn(B, S, NKV, hd, dtype=dtype), \
                randn(B, S, NKV, hd, dtype=dtype)
            for name, (make, copies) in layouts.items():
                q = make(q0)
                if dname == "float32" and copies:
                    copies = 0          # the float32 kernel reads element-wise
                before = kernel.layout_copies
                got = mha_flash(q, k, v, causal=True)
                made = kernel.layout_copies - before
                ref = _ref_bshd(q0, k, v, NH // NKV, causal=True)
                torch.cuda.synchronize()
                r = tol_ratio(got, ref, dname)
                say(f"  {dname:8s} hd={hd:3d} B={B} S={S} {name}: strides {tuple(q.stride())}, "
                    f"{made} layout copies, {r:.2f} of tolerance")
                if not (r <= 1.0 and got.shape == (B, S, NH, hd) and got.is_contiguous()):
                    fail(f"model layout '{name}' disagrees: {r:.3f} of tolerance")
                if made != copies:
                    fail(f"model layout '{name}' took {made} layout copies, expected {copies}")

    # a captured call replayed on new values written into its inputs in place
    q, k, v = (randn(1, 512, n, 128, dtype=torch.bfloat16) for n in (NH, NKV, NKV))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mha_flash(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mha_flash(q, k, v)
    for step in range(2):
        for t in (q, k, v):
            t.copy_(randn(*t.shape, dtype=t.dtype))
        out.fill_(float("nan"))
        graph.replay()
        ref = _ref_bshd(q, k, v, NH // NKV, causal=True)
        torch.cuda.synchronize()
        r = tol_ratio(out, ref, "bfloat16")
        say(f"  graph replay {step + 1} after writing new q, k, v in place: "
            f"{r:.2f} of tolerance")
        if not r <= 1.0:
            fail(f"a replay on inputs changed in place disagrees: {r:.3f} of tolerance")


def flash_timing(describe=None, q_heads: int = 24, kv_heads: int = 8,
                 lengths=TIMED_LENGTHS, model: str = "phi4-mini") -> dict:
    """B1 at a model's prefill shapes (q (q_heads,S,128), kv (kv_heads,S,128),
    bf16, causal, B=1; by default phi4-mini's, at every prefill bucket and
    S=2048): kernel, ``F.scaled_dot_product_attention`` (a yardstick only:
    the port never calls it) and the plain version, each inside a CUDA graph
    and launched from Python, beside the card's bound.  ``describe(q, k, v)``
    names the launch the kernel makes.  Returns the record of S=512, the
    largest prefill bucket, with every length under ``by_length``."""
    say(f"-- timing at {model} prefill shapes: q ({q_heads},S,128), kv ({kv_heads},S,128), "
        "bf16, causal; ms per call in a CUDA graph (graph) and launched from Python (eager)")
    record, by_length = {}, {}
    for S in lengths:
        entry = flash_time(q_heads, kv_heads, S, S, 128, True, f"S={S}", describe)
        by_length[S] = entry
        if S == max(PREFILL_BUCKETS):
            record = dict(entry)
    record["by_length"] = by_length
    return record


def flash_time(q_heads: int, kv_heads: int, Sq: int, Skv: int, hd: int, causal: bool,
               label: str, describe=None) -> dict:
    """B1 on q (q_heads, Sq, hd) and k/v (kv_heads, Skv, hd), bf16, against
    its plain version, then timed with ``F.scaled_dot_product_attention``
    and the plain version, each inside a CUDA graph and launched from
    Python, beside the card's bound; returns the record."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    group = q_heads // kv_heads
    q, k, v = _qkv(kv_heads, group, Sq, Skv, hd, torch.bfloat16, seed=100 + Sq)
    kw = dict(group=group, causal=causal)
    got, ref = flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    if not tol_ratio(got, ref, "bfloat16") <= 1.0:
        fail(f"kernel disagrees at {label}: max_abs_err {err}")
    q4, k4, v4 = q[None], k[None], v[None]
    calls = {"kernel": lambda: flash_attention(q, k, v, **kw),
             "plain": lambda: flash_attention_ref(q, k, v, **kw),
             "library": lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=causal, enable_gqa=True)}
    iters = 50 if Sq * Skv <= 512 * 512 else 20
    graphed = {name: graph_ms(fn, reps=10 if name == "plain" else 20,
                              iters=5 if name == "plain" else iters)
               for name, fn in calls.items()}
    eager = {name: time_ms(fn, 5 if name == "plain" else iters)
             for name, fn in calls.items()}
    # (query, key) pairs per head: causal (top-left aligned) or all; 4*hd
    # operations each
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    flops = 4.0 * hd * q_heads * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    launch = f" | {describe(q, k, v)}" if describe else ""
    say(f"  {label} (q ({q_heads},{Sq},{hd}) kv ({kv_heads},{Skv},{hd}) causal {int(causal)}): "
        f"graph kernel_ms {graphed['kernel']:.5f} plain_ms "
        f"{graphed['plain']:.5f} library_ms {graphed['library']:.5f} | eager "
        f"kernel_ms {eager['kernel']:.5f} plain_ms {eager['plain']:.5f} library_ms "
        f"{eager['library']:.5f} | bound_ms {bound_ms:.5f} ({bound_by}) | kernel at "
        f"{bound_ms / graphed['kernel']:.1%} of bound, "
        f"{graphed['library'] / graphed['kernel']:.3f}x the library's speed | "
        f"max_abs_err {err:.3e}{launch}")
    return dict(max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=graphed["library"],
                eager_ms=eager["kernel"], eager_library_ms=eager["library"])


def serve_on_card(cfg) -> tuple:
    """Serve ``cfg`` on the card: random weights drawn there from seed 0,
    then 8 requests of 20-500 prompt tokens and 16 new ones through a
    ``ServingEngine`` of 4 slots of 1024 positions, buckets 64-512, its
    steps sealed as CUDA graphs.  Fails unless every request finished with
    tokens in range and the graph replays equal the requests and the
    steps.  Returns the drained engine and the wrappers' counts over the
    served run: stream_pack launches, flash launches, layout copies."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    params = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"weights: {n_params / 1e9:.3f} B parameters ({torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card), initialised on the card in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()

    pack.launches = flash.launches = flash.layout_copies = 0   # the path's run starts here
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_len=1024,
                           bucketing=f"pow2:{min(PREFILL_BUCKETS)}:{max(PREFILL_BUCKETS)}",
                           device="cuda")
    seal_s = time.perf_counter() - t0
    reqs = serve.make_requests(cfg, 8, max_new=16, seed=0, min_len=20, max_len=501)
    res = serve.serve(engine, reqs)
    torch.cuda.synchronize()
    counts = (pack.launches, flash.launches, flash.layout_copies)   # ... and ends here
    st = engine.stats
    captures = st.prefill_compiles + st.decode_compiles
    say(f"seal {seal_s:.2f}s ({st.prefill_compiles} prefill buckets + "
        f"{st.decode_compiles} decode captured) | prompt lengths "
        f"{sorted(len(r.prompt) for r in reqs)}")
    say(f"served {len(res['done'])} requests in {res['wall_s']:.3f}s | TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.2f}ms | decode {res['decode_tok_per_s']:.1f} tok/s "
        f"over {st.steps} steps | peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"CUDA graphs: {captures} captures, {st.prefill_replays} prefill + "
        f"{st.decode_replays} decode replays | wrapper calls (eager warm-up runs, plus "
        f"graph captures that record the kernel without running it): stream_pack "
        f"{counts[0]}, flash {counts[1]}; layout copies {counts[2]}")

    if len(res["done"]) != len(reqs):
        fail(f"{len(res['done'])} of {len(reqs)} requests finished")
    for r in res["done"]:
        if r.error or not (len(r.generated) == 16 or r.truncated):
            fail(f"request {r.rid}: {len(r.generated)} tokens, error {r.error}")
        toks = np.asarray(r.generated)
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"request {r.rid}: token outside [0, {cfg.vocab})")
    if st.prefill_replays != len(reqs) or st.decode_replays != st.steps:
        fail(f"graph replays: prefill {st.prefill_replays}, decode "
             f"{st.decode_replays} over {st.steps} steps")
    return engine, counts


def phase_serve() -> tuple[int, int | None]:
    """Returns the flash wrapper's calls over the served run, and the flash
    kernels the profiler saw in one profiled prefill replay (None if it saw
    no device time there)."""
    import repro_torch.configs as C

    say("== phase 4: serve phi4-mini-3.8b, full width and depth, bf16, on the card")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    engine, (_, launches, copies) = serve_on_card(cfg)
    st = engine.stats
    if launches < cfg.n_layers * st.prefill_compiles or st.prefill_compiles < 1:
        fail(f"flash kernel launched {launches} times for {st.prefill_compiles} "
             f"captured prefill buckets: not on the main path")
    if copies != 0:
        fail(f"the served run made {copies} layout copies for the flash kernel: "
             "the model's layouts must be read in place")
    in_replays = step_breakdown(engine)
    return launches, in_replays


def _poison(out) -> None:
    """Fill the tensors ``out`` holds with values no run writes: NaN, or -1
    where they hold integers (token ids)."""
    import torch
    from torch.utils import _pytree as pytree

    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t.fill_(float("nan") if t.is_floating_point() else -1)


def _same_outputs(got, want) -> bool:
    import torch
    from torch.utils import _pytree as pytree

    got = [t for t in pytree.tree_leaves(got) if isinstance(t, torch.Tensor)]
    want = [t for t in pytree.tree_leaves(want) if isinstance(t, torch.Tensor)]
    return len(got) == len(want) and all(
        g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        and ratio(g, w, 1e-5, 1e-5) <= 1.0 for g, w in zip(got, want))


def kernels_in_one(run, check: bool = True, attempts: int = 4) -> list:
    """The device kernels (torch.profiler events) of one call of ``run``,
    after one unprofiled call.

    With ``check`` (a call that computes the same outputs each time, as a
    graph replay does) the outputs of the call before are poisoned before
    each profiled call (a graph replay writes into those same tensors
    anew), and the profiled call must give the unprofiled call's outputs
    again: one that ran nothing fails the run.  Only then is a reading
    taken, and only when two sessions in a row record the same kernels:
    an H100 run has returned an empty activity buffer for a replay, and
    another a buffer of 25 of a replay's 300-odd kernels.  Up to
    ``attempts`` sessions; if no two in a row agree, the reading with the
    most device events.  Without ``check`` (a call that moves state, as an
    eager decode step does) one session is taken."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    events: list = []
    readings: list = []                  # (kernel counts, events) of each session
    with torch.no_grad():
        last = run()
        torch.cuda.synchronize()
        want = pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, last)
        for _ in range(attempts if check else 1):
            if check:
                _poison(last)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                last = run()
                torch.cuda.synchronize()
            if check and not _same_outputs(last, want):
                fail("a profiled call did not give the outputs of the call before it: "
                     "it ran nothing, or not all of its work")
            events = [e for e in prof.events()
                      if "cuda" in str(getattr(e, "device_type", "")).lower()]
            if not check:
                break
            if not events:
                say("    (the profiler recorded no device event for a call whose outputs "
                    "were right: profiling again)")
                continue
            counts = collections.Counter(e.name for e in events)
            if readings and readings[-1][0] == counts:
                break
            if readings:
                say(f"    (two profiler sessions of one call recorded {len(readings[-1][1])} "
                    f"and {len(events)} device events: profiling again)")
            readings.append((counts, events))
        else:
            if check and readings:
                events = max((ev for _, ev in readings), key=len)
    return events


def by_kernel(events) -> list[tuple[float, int, str]]:
    """(device µs, count, name) of each kernel among ``events``."""
    by_name: dict[str, tuple[float, int]] = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return [(us, count, name) for name, (us, count) in by_name.items()]


def replay_times(engine):
    """Print the graph-replay times of the decode step and of each prefill
    bucket (CUDA events); returns the decode step's token input."""
    import torch

    params, cache = engine.params, engine.kv_cache
    toks = torch.zeros((engine.max_slots, 1), dtype=torch.long)
    parts = [f"decode step {time_ms(lambda: engine._decode(params, cache, toks), 20):.3f}"]
    for b in engine.prompt_buckets:
        exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
        parts.append(f"prefill {b} {time_ms(lambda: exe(params, cache, padded, 0, b), 5):.3f}")
    say(f"graph replay ms: {' | '.join(parts)}")
    return toks


def step_breakdown(engine) -> int | None:
    """Where a served step's time goes: graph-replay times of the decode
    step and of each prefill bucket (CUDA events), then the device time
    of one eager decode step and one eager bucket-512 prefill by kernel
    (torch.profiler).  Returns the flash kernels the profiler saw run
    inside one prefill graph replay (None if it saw no device time there).
    Runs on the drained engine; only its idle cache is overwritten."""
    import torch

    params, cache = engine.params, engine.kv_cache
    toks = replay_times(engine)

    # replays do not pass through the wrapper's counter: count the flash
    # kernels that one replay runs on the card
    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    rows = by_kernel(kernels_in_one(lambda: exe(params, cache, padded, 0, b)))
    per_replay = None
    if rows:
        per_replay = sum(c for _, c, key in rows if "flash_fwd" in key)
        say(f"one prefill {b} graph replay ran {sum(c for _, c, _ in rows)} device ops, "
            f"{per_replay} of them flash_fwd (torch.profiler)")
        if per_replay != engine.cfg.n_layers:
            fail(f"a prefill replay ran {per_replay} flash kernels for "
                 f"{engine.cfg.n_layers} layers")
    else:
        say(f"one prefill {b} graph replay: the profiler saw no device time")

    dev = engine.device
    eager = {
        "decode": lambda: engine._decode_impl(params, cache, toks.to(dev)),
        "prefill 512": lambda: engine._prefill_dyn(
            params, cache, torch.zeros((1, 512), dtype=torch.long, device=dev),
            torch.tensor(0, device=dev), torch.tensor(512, device=dev)),
    }
    for name, fn in eager.items():
        rows = by_kernel(kernels_in_one(fn, check=False))
        total = sum(r[0] for r in rows)
        if total <= 0:
            say(f"eager {name}: the profiler saw no device time")
            continue
        copies = sum(count for _, count, key in rows if "copy" in key.lower())
        say(f"eager {name}: {total / 1e3:.3f} ms of device time, {len(rows)} kernel names, "
            f"{sum(count for _, count, _ in rows)} kernels, {copies} of them copy kernels; "
            "top kernels:")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    return per_replay


def phase_cpu_parity() -> None:
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models import Transformer, prefill
    from repro_torch.serving import ServingEngine

    say("== phase 5: card against CPU, phi4-mini full width, 2 layers, float32 "
        "(logits within 1e-3: float32 summation order differs across devices)")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), n_layers=2, dtype="float32")
    p_gpu = serve.init_params(cfg, seed=1, device="cuda")
    p_cpu = Transformer(cfg, device="cpu")
    p_cpu.load_state_dict(p_gpu.state_dict())

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (1, 64)).astype(np.int64))
    with torch.no_grad():
        lg = prefill(p_gpu, tokens.cuda(), cfg)[0][..., : cfg.vocab].cpu()
        lc = prefill(p_cpu, tokens, cfg)[0][..., : cfg.vocab]
    err = (lg - lc).abs().max().item()
    say(f"prefill logits (1, 64, {cfg.vocab}): max |cuda - cpu| {err:.3e}")
    if not err <= 1e-3:
        fail(f"prefill logits differ by {err} > 1e-3")

    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        engine = ServingEngine(cfg, params, max_slots=4, max_len=128,
                               bucketing=(64,), device=dev)
        reqs = serve.make_requests(cfg, 4, max_new=8, seed=2, min_len=8, max_len=65)
        out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
    say(f"greedy tokens cuda: {out['cuda']}")
    say(f"greedy tokens cpu:  {out['cpu']}")
    if out["cuda"] != out["cpu"]:
        fail("greedy tokens differ between the card and the CPU")


# stream_pack (atol, rtol): float32 differs from its plain version only by
# summation order; bf16 also by the rounding of the output to bf16
PACK_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}
# (lanes, M, K, N) of the packed mm groups of the four branchy cells
BRANCHY_PACKS = {"darts-like": (7, 8, 64, 64), "nasnet-m-like": (12, 8, 48, 48),
                 "amoebanet-like": (11, 8, 56, 56), "inception-like": (6, 8, 96, 96)}
# phase 6's (M, K, N): PR 12's ten, then K or N off the 16-byte vector
# (element-wise loads), and K deep enough that the f32 panel does not fit
# (the ring at 8, 16 and 32 rows)
PACK_SHAPES = [(16, 16, 16), (64, 32, 16), (128, 128, 128), (256, 64, 128), (8, 64, 64),
               (8, 48, 48), (8, 56, 56), (8, 96, 96), (32, 256, 256), (200, 72, 40),
               (8, 13, 7), (33, 40, 29), (8, 1024, 64), (8, 1022, 40), (16, 1024, 64),
               (64, 1024, 64)]
# ... and with x 4 bytes past a 16-byte boundary, which takes the element-wise
# loads of every tile
PACK_OFFSET_SHAPES = [(8, 64, 64), (33, 40, 29), (16, 16, 16), (32, 256, 256),
                      (16, 1024, 64), (64, 1024, 64)]


def pack_cases() -> list[tuple[str, int, tuple[int, int, int], bool, int]]:
    """Phase 6's (dtype, lanes, (M, K, N), shared x, x's byte offset) cases."""
    cases = [(dname, lanes, mkn, shared, 0) for dname in ("float32", "bfloat16")
             for lanes in (1, 2, 7, 12) for mkn in PACK_SHAPES for shared in (False, True)]
    return cases + [(dname, lanes, mkn, shared, 4) for dname in ("float32", "bfloat16")
                    for lanes in (1, 7) for mkn in PACK_OFFSET_SHAPES
                    for shared in (False, True)]


def _pack_inputs(lanes, M, K, N, dtype, shared, seed, offset=0):
    """x (lanes, M, K), a stride-0 broadcast of one (M, K) when shared, and
    w (lanes, K, N), standard normal on the card.  ``offset`` > 0 puts x's
    first element that many bytes past a 16-byte boundary."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = (1 if shared else lanes) * M * K
    skip = offset // torch.empty((), dtype=dtype).element_size()
    x = torch.randn(skip + rows, generator=g, device="cuda").to(dtype)[skip:]
    x = x.view(M, K).expand(lanes, M, K) if shared else x.view(lanes, M, K)
    w = torch.randn((lanes, K, N), generator=g, device="cuda").to(dtype)
    return x, w


def _tile(launch) -> str:
    return (f"{launch.variant} tile {launch.bm}x{launch.bn} kc {launch.kc} stages "
            f"{launch.stages} grid {launch.grid} smem {launch.smem_bytes} B")


def phase_stream_pack() -> dict:
    import torch

    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import stream_pack_matmul, stream_pack_matmul_ref

    say("== phase 6: stream_pack kernel vs plain version (tolerance |err| <= atol + "
        "rtol*|ref|: f32 1e-4 + 1e-5*|ref| for summation order; bf16 1e-2 + "
        "1e-2*|ref| for the rounding of the output)")
    cases = pack_cases()
    worst, reached = 0.0, {}
    for n, (dname, lanes, (M, K, N), shared, offset) in enumerate(cases):
        x, w = _pack_inputs(lanes, M, K, N, getattr(torch, dname), shared, seed=n,
                            offset=offset)
        launch = pack.launch_for(x, w)
        # one block per dimension passes the TPU's block check for any
        # shape; the CUDA tile still meets the ragged edge
        got = stream_pack_matmul(x, w, block_m=M, block_n=N, block_k=K)
        ref = stream_pack_matmul_ref(x, w)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        r = ratio(got, ref, *PACK_TOL[dname])
        if not (math.isfinite(err) and r <= 1.0):
            fail(f"stream_pack disagrees at {dname} lanes={lanes} M={M} K={K} N={N} "
                 f"shared={shared} x offset {offset} B ({_tile(launch)}): max_abs_err "
                 f"{err} ({r:.3f} of tolerance {PACK_TOL[dname]})")
        worst = max(worst, r)
        reached[launch.instance] = reached.get(launch.instance, 0) + 1
    say(f"  float32 and bfloat16: lanes 1/2/7/12 x {len(PACK_SHAPES)} shapes x "
        f"shared/separate, and lanes 1/7 x {len(PACK_OFFSET_SHAPES)} shapes x "
        f"shared/separate with x 4 bytes off 16: all within tolerance")
    say(f"  {len(cases)} cases within tolerance (worst at {worst:.2f} of its tolerance); "
        f"cases by kernel (variant, bm, bn): "
        + ", ".join(f"{v} {bm}x{bn} {n}" for (v, bm, bn), n in sorted(reached.items())))
    missing = set(pack.INSTANCES) - set(reached)
    if missing:
        fail(f"phase 6 never launched the stream_pack kernels {sorted(missing)}")

    say("-- timing: the branchy cells' packed mm groups (f32, shared x) and one bf16 shape")
    record = {}
    cases = [(name, *lmkn, "float32", True) for name, lmkn in BRANCHY_PACKS.items()]
    cases.append(("bf16 12x32x256x256", 12, 32, 256, 256, "bfloat16", False))
    for name, lanes, M, K, N, dname, shared in cases:
        x, w = _pack_inputs(lanes, M, K, N, getattr(torch, dname), shared, seed=1000 + lanes)
        launch = pack.launch_for(x, w)
        got, ref = stream_pack_matmul(x, w), stream_pack_matmul_ref(x, w)
        err = (got.float() - ref.float()).abs().max().item()
        if not ratio(got, ref, *PACK_TOL[dname]) <= 1.0:
            fail(f"stream_pack disagrees at {name}: max_abs_err {err}")
        calls = {"kernel": lambda: stream_pack_matmul(x, w),
                 "plain": lambda: stream_pack_matmul_ref(x, w),
                 "library": lambda: torch.matmul(x, w)}
        # launched one by one from Python, and inside a CUDA graph
        eager = {k: time_ms(f, 200) for k, f in calls.items()}
        graphed = {k: graph_ms(f) for k, f in calls.items()}
        kernel_ms, plain_ms, library_ms = graphed["kernel"], graphed["plain"], graphed["library"]
        itemsize = x.element_size()
        # each input read once (a shared x once, not once per lane), the
        # output written once
        nbytes = ((1 if shared else lanes) * M * K + lanes * K * N + lanes * M * N) * itemsize
        flops = 2.0 * lanes * M * N * K
        t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        say(f"  {name} (lanes {lanes}, M {M}, K {K}, N {N}, {dname}, shared x {shared}; "
            f"{_tile(launch)}): in a CUDA graph kernel_ms {kernel_ms:.5f} plain_ms "
            f"{plain_ms:.5f} library_ms {library_ms:.5f} | launched from Python kernel_ms {eager['kernel']:.5f} "
            f"plain_ms {eager['plain']:.5f} library_ms {eager['library']:.5f} | "
            f"bound_ms {bound_ms:.6f} ({bound_by}) max_abs_err {err:.3e} | "
            f"{flops / 1e6:.3f} MFLOP, {nbytes / 1e3:.1f} KB")
        if name == "darts-like":     # the first cell of the main path's run
            record = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    record["expert_shapes"] = expert_gemms()
    return record


# phase 6's MoE expert GEMMs on B2: (lanes, d_model, d_ff_expert) of each
# served MoE model; w_gate and w_up are (lanes, d_model, d_ff_expert), w_down
# (lanes, d_ff_expert, d_model), and M is the capacity serving gives them
EXPERT_GEMMS = {"arctic-480b": (128, 7168, 4864), "deepseek-v2-236b": (160, 5120, 1536)}
# the M that are timed: 4 decode slots, and prefill bucket 64 (dropless)
EXPERT_TIMED_M = (4, 64)
# lanes per call of the plain version on the card, which upcasts w to float32
# (17.8 GB for all of arctic's lanes)
REF_LANES = 16


def expert_capacities(arch: str) -> tuple[int, ...]:
    """Every M the served path gives ``arch``'s expert GEMMs: the capacity
    of a decode step over ``SERVE_SLOTS`` slots and of a prefill at each of
    ``PREFILL_BUCKETS``."""
    import repro_torch.configs as C
    from repro_torch.models.moe import capacity

    cfg = C.get(arch)
    return tuple(sorted({capacity(n, cfg) for n in (SERVE_SLOTS,) + PREFILL_BUCKETS}))


def expert_gemms() -> list[dict]:
    """B2 at the MoE expert GEMMs, bf16, random normal operands, at every M
    of :func:`expert_capacities`: against the plain version, computed
    REF_LANES lanes at a time, under ``PACK_TOL``; then, at the M of
    ``EXPERT_TIMED_M``, times in a CUDA graph and launched from Python beside one
    ``torch.bmm`` over the same operands (a yardstick only: the port never
    calls it), the plain version (launched from Python) and the bound,
    which is the weights' bytes."""
    import torch

    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import stream_pack, stream_pack_matmul_ref

    say("-- the MoE expert GEMMs at full width, bf16 (x (lanes,M,K) @ w (lanes,K,N)), at every "
        f"capacity the served path gives them, timed at M {EXPERT_TIMED_M}; ms per call")
    entries = []
    for arch, (lanes, D, F) in EXPERT_GEMMS.items():
        for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
            g = torch.Generator(device="cuda").manual_seed(lanes + K)
            w = torch.randn((lanes, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            for M in expert_capacities(arch):
                x = torch.randn((lanes, M, K), generator=g, device="cuda", dtype=torch.bfloat16)
                launch = pack.launch_for(x, w)
                got = stream_pack(x, w)
                worst = err = 0.0
                for i in range(0, lanes, REF_LANES):
                    ref = stream_pack_matmul_ref(x[i:i + REF_LANES], w[i:i + REF_LANES])
                    part = got[i:i + REF_LANES]
                    worst = max(worst, ratio(part, ref, *PACK_TOL["bfloat16"]))
                    err = max(err, (part.float() - ref.float()).abs().max().item())
                    del ref
                if not (math.isfinite(err) and worst <= 1.0):
                    fail(f"stream_pack disagrees at {arch} {gemm} M={M}: max_abs_err {err} "
                         f"({worst:.3f} of tolerance {PACK_TOL['bfloat16']})")
                if M not in EXPERT_TIMED_M:
                    say(f"  {arch} {gemm} lanes {lanes} M {M} K {K} N {N} ({_tile(launch)}): "
                        f"{worst:.2f} of tolerance, max_abs_err {err:.3e}")
                    continue
                calls = {"kernel": lambda: stream_pack(x, w), "library": lambda: torch.bmm(x, w)}
                graphed = {k: graph_ms(f, reps=5, iters=10) for k, f in calls.items()}
                eager = {k: time_ms(f, 20) for k, f in calls.items()}
                plain_ms = time_ms(lambda: stream_pack_matmul_ref(x, w), 3, warmup=1)
                nbytes = (lanes * M * K + lanes * K * N + lanes * M * N) * 2
                flops = 2.0 * lanes * M * N * K
                t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
                bound_ms = max(t_ops, t_bytes) * 1e3
                bound_by = "operations" if t_ops >= t_bytes else "bytes"
                say(f"  {arch} {gemm} lanes {lanes} M {M} K {K} N {N} ({_tile(launch)}): "
                    f"{worst:.2f} of tolerance, max_abs_err {err:.3e} | in a CUDA graph "
                    f"kernel_ms {graphed['kernel']:.5f} library_ms (torch.bmm) "
                    f"{graphed['library']:.5f} | from Python kernel_ms {eager['kernel']:.5f} "
                    f"library_ms {eager['library']:.5f} plain_ms {plain_ms:.5f} | bound_ms "
                    f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e9:.3f} GB) | kernel at "
                    f"{bound_ms / graphed['kernel']:.1%} of bound, "
                    f"{graphed['library'] / graphed['kernel']:.3f}x the library's speed")
                entries.append(dict(model=arch, gemm=gemm, lanes=lanes, M=M, K=K, N=N,
                                    variant=launch.variant, bm=launch.bm, max_abs_err=err,
                                    ms=graphed["kernel"], eager_ms=eager["kernel"],
                                    plain_ms=plain_ms, library_ms=graphed["library"],
                                    eager_library_ms=eager["library"], bound_ms=bound_ms,
                                    bound_by=bound_by))
            del w, x, got
            torch.cuda.empty_cache()
    return entries


def span(events) -> str:
    """Summed kernel time and the device span of one call (µs)."""
    if not events:
        return "no device time seen"
    busy = sum(e.time_range.elapsed_us() for e in events)
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    return f"kernels {busy:.2f} us over a span of {t1 - t0:.2f} us"


def phase_nimble() -> tuple[int, int, int]:
    """Returns the stream_pack wrapper's calls over the run, the
    stream_pack kernels the profiler saw in the profiled packed replays, and
    the number of those replays (one per cell)."""
    import torch

    from repro_torch.configs import branchy_cell
    from repro_torch.core import EagerInterpreter, JitPerOpEngine, Nimble
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.models.branchy import branchy_forward, example_input, init_branchy

    say("== phase 7: Nimble on the four branchy cells, full size, float32, on the card "
        "(replays within 1e-5 + 1e-5*|ref| of eager: the same aten kernels, cuBLAS may "
        "pick another algorithm under capture; packed within 1e-4 + 1e-4*|ref|)")
    configs = [branchy_cell.darts_like(), branchy_cell.nasnet_mobile_like(),
               branchy_cell.amoebanet_like(), branchy_cell.inception_like()]
    data = []
    for cfg in configs:
        params, other = (init_branchy(torch.Generator(device="cuda").manual_seed(seed), cfg,
                                      device="cuda") for seed in (0, 1))
        data.append((cfg, params, other, example_input(cfg, 0, device="cuda")))
    torch.cuda.synchronize()

    pack.launches = 0                     # the main path's run starts here
    in_replays = 0                        # stream_pack kernels seen in profiled replays
    mm_groups_total = 0
    for cfg, params, other, x in data:
        def fn(p, x, _cfg=cfg):
            return branchy_forward(p, x, _cfg)

        with torch.no_grad():
            ref = fn(params, x).clone()
        engines, nimbles = {}, {}
        engines["eager"] = lambda: fn(params, x)
        engines["interpreter"] = lambda e=EagerInterpreter(fn, params, x): e(params, x)
        engines["jit_per_op"] = lambda e=JitPerOpEngine(fn, params, x): e(params, x)
        for name, kw in (("single_stream", dict(multi_stream=False)), ("multi_stream", {}),
                         ("packed", dict(pack_streams=True))):
            nimbles[name] = Nimble(fn, params, x, **kw)
            engines[name] = lambda n=nimbles[name]: n(params, x)
        st = nimbles["multi_stream"].stats
        report = nimbles["packed"].schedule.pack_report
        mm_groups = sum(1 for op, _ in report.groups if op == "mm")
        mm_groups_total += mm_groups
        say(f"  {cfg.name}: {st.num_tasks} tasks, {st.num_streams} streams, {st.num_syncs} "
            f"syncs, degree {st.degree_of_concurrency}, pack groups {report.groups} "
            f"({report.baked_groups} baked)")
        pool = {name: n.stats.device_bytes for name, n in nimbles.items()}
        say(f"    planned arena_bytes {st.arena_bytes} | graph pool bytes (ScheduleStats."
            f"device_bytes, the change of memory_allocated across schedule): single "
            f"{pool['single_stream']}, multi {pool['multi_stream']}, packed {pool['packed']} "
            f"(packed includes its pre-stacked weights)")

        # correctness: each engine against eager, then each replay on
        # another input and on other weights, which it copies into its
        # static inputs (shared by the three schedules; the packed one
        # re-stacks the weights it baked): restored after each from copies
        tols = {"interpreter": (1e-5, 1e-5), "jit_per_op": (1e-5, 1e-5),
                "single_stream": (1e-5, 1e-5),
                "multi_stream": (1e-5, 1e-5), "packed": (1e-4, 1e-4)}
        x0, x2 = x.clone(), example_input(cfg, 1, device="cuda")
        p0 = {k: v.clone() for k, v in params.items()}
        with torch.no_grad():
            ref2, ref3 = fn(params, x2).clone(), fn(other, x2).clone()
        for name, (atol, rtol) in tols.items():
            got = engines[name]().clone()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{cfg.name} {name}: shape {tuple(got.shape)} or non-finite output")
            r = ratio(got, ref, atol, rtol)
            if not r <= 1.0:
                fail(f"{cfg.name} {name} differs from eager: {r:.3f} of tolerance")
            if name in nimbles:
                got2 = nimbles[name](params, x2).clone()
                got3 = nimbles[name](other, x2).clone()
                back = nimbles[name](p0, x0).clone()
                for what, g, want in (("another input", got2, ref2),
                                      ("other weights", got3, ref3),
                                      ("the first weights again", back, ref)):
                    r2 = ratio(g, want, atol, rtol)
                    if not r2 <= 1.0:
                        fail(f"{cfg.name} {name} on {what}: {r2:.3f} of tolerance")
        if not (torch.equal(x, x0) and all(torch.equal(params[k], p0[k]) for k in p0)):
            fail(f"{cfg.name}: the static inputs were not restored")
        # B2 sums each output in a fixed order: two replays give the same bits
        first, second = engines["packed"]().clone(), engines["packed"]().clone()
        if not torch.equal(first, second):
            fail(f"{cfg.name}: two packed replays differ by "
                 f"{(first - second).abs().max().item()}")
        torch.cuda.synchronize()

        iters = 200
        us = {name: time_ms(run, iters, warmup=5) * 1e3 for name, run in engines.items()}
        say("    us per call (CUDA events, mean of 200 after 5 warm-up): " + " | ".join(
            f"{name} {v:.2f}" for name, v in us.items())
            + f" | multi/single {us['single_stream'] / us['multi_stream']:.3f}x")

        for name in ("single_stream", "multi_stream"):
            events = kernels_in_one(engines[name])
            ids = sorted({getattr(e, "device_resource_id", None) for e in events} - {None})
            say(f"    one {name} replay: {len(events)} device ops on "
                f"{len(ids) if ids else 'not measured'} stream ids {ids[:48]}; {span(events)}")
            if name == "single_stream":
                top = sorted(by_kernel(events), reverse=True)[:3]
                say("      top kernels: " + " | ".join(
                    f"{us:.2f} us x{count} {key[:70]}" for us, count, key in top))
        events = kernels_in_one(engines["packed"])
        b2_events = [e for e in events if "stream_pack_" in e.name]
        b2 = len(b2_events)
        b2_us = sum(e.time_range.elapsed_us() for e in b2_events)
        say(f"    one packed replay: {len(events)} device ops, {b2} stream_pack kernels "
            f"for {mm_groups} mm pack groups (torch.profiler); {span(events)}; "
            f"stream_pack kernels {b2_us:.2f} us ("
            + ", ".join(f"{e.time_range.elapsed_us():.2f}" for e in b2_events)
            + "); two replays bit-identical")
        if b2 != mm_groups:
            fail(f"{cfg.name}: the profiler saw {b2} stream_pack kernels in a packed "
                 f"replay for {mm_groups} mm groups")
        in_replays += b2
    torch.cuda.synchronize()
    launches = pack.launches             # ... and ends here
    say(f"stream_pack wrapper calls {launches} (one warm-up run and one graph capture, "
        f"which records the kernel without running it, per mm group); the profiler saw "
        f"{in_replays} stream_pack kernels in the {len(data)} profiled packed replays, "
        f"one per cell")
    if launches != 2 * mm_groups_total:
        fail(f"stream_pack launched {launches} times for {mm_groups_total} packed mm "
             f"groups: not on Nimble's packed path")
    return launches, in_replays, len(data)


def release() -> None:
    """Give back the memory of the phases before: their engines hold
    reference cycles (sealed steps that call back into the engine), so
    collect them, then return the cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    say(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def phase_serve_moe(arch: str, number: int, n_layers: int = 2) -> dict:
    """Serve ``arch`` at full width and ``n_layers`` layers, bf16, as phase 4
    serves phi4-mini.  Returns the wrappers' counts over the served run
    and the kernels the profiler saw in one decode and one prefill replay."""
    import repro_torch.configs as C

    say(f"== phase {number}: serve {arch}, full width, {n_layers} layers, bf16, on the card")
    release()
    cfg = dataclasses.replace(C.get(arch), n_layers=n_layers, dtype="bfloat16")
    say(f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of width {cfg.moe.d_ff_expert}"
        + (f" beside a dense FFN of {cfg.d_ff}" if cfg.d_ff else "")
        + (f", {cfg.moe.num_shared_experts} shared" if cfg.moe.num_shared_experts else "")
        + f", d_model {cfg.d_model}, "
        + ("MLA" if cfg.mla else f"GQA {cfg.n_heads} over {cfg.n_kv_heads} heads"))
    engine, (b2, fl, copies) = serve_on_card(cfg)
    st = engine.stats
    captures = st.prefill_compiles + st.decode_compiles
    # three expert GEMMs per layer in every sealed step, each launched once
    # by the warm-up run and once by the capture; prefill attention on B1
    # for GQA, none for MLA (plain PyTorch)
    want_flash = 0 if cfg.mla else 2 * n_layers * st.prefill_compiles
    if b2 != 2 * 3 * n_layers * captures or fl != want_flash or copies:
        fail(f"stream_pack wrapper calls {b2} (want {2 * 3 * n_layers * captures}), flash "
             f"{fl} (want {want_flash}), layout copies {copies}: not the main path")
    seen = moe_replays(engine)
    return dict(b2_launches=b2, flash_launches=fl, **seen)


def moe_replays(engine) -> dict:
    """:func:`replay_times`, then the device kernels of one decode replay
    and one prefill replay of the largest bucket (torch.profiler): each
    must run 3 × n_layers B2 kernels, and the prefill n_layers
    ``flash_fwd`` unless the model attends with MLA.  A decode replay moves
    the cache's offsets, so the profiled one starts from the same offsets
    as the call before it."""
    import torch

    params, cache, cfg = engine.params, engine.kv_cache, engine.cfg
    L = cfg.n_layers
    toks = replay_times(engine)
    pos0 = cache["pos"].clone()

    def decode_replay():
        cache["pos"].copy_(pos0)
        return engine._decode(params, cache, toks)

    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    seen = {"b2_in_replays": 0, "flash_in_replays": 0, "profiled_replays": 0}
    for name, run in (("decode", decode_replay),
                      (f"prefill {b}", lambda: exe(params, cache, padded, 0, b))):
        rows = by_kernel(kernels_in_one(run))
        if not rows:
            fail(f"one {name} graph replay: the profiler saw no device time")
        total = sum(us for us, _, _ in rows)
        b2_us = sum(us for us, _, key in rows if "stream_pack_" in key)
        b2 = sum(c for _, c, key in rows if "stream_pack_" in key)
        fl = sum(c for _, c, key in rows if "flash_fwd" in key)
        say(f"one {name} graph replay: {sum(c for _, c, _ in rows)} device ops, "
            f"{total / 1e3:.3f} ms of kernels; {b2} stream_pack kernels, {b2_us / 1e3:.3f} ms "
            f"({b2_us / total:.1%} of the kernel time); {fl} flash_fwd (torch.profiler); top:")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
        want_fl = L if name != "decode" and cfg.mla is None else 0
        if b2 != 3 * L or fl != want_fl:
            fail(f"a {name} replay ran {b2} stream_pack and {fl} flash kernels for {L} "
                 f"layers (want {3 * L} and {want_fl})")
        seen["b2_in_replays"] += b2
        seen["flash_in_replays"] += fl
        seen["profiled_replays"] += 1
    return seen


def phase_moe_cpu_parity(number: int) -> None:
    """The MoE smoke configs through ``ServingEngine`` on the card and on
    the CPU, one set of weights (drawn on the card, copied over)."""
    import repro_torch.configs as C
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: card against CPU, arctic-smoke and deepseek-v2-smoke, float32 "
        "(identical greedy tokens; B2 takes its float32 kernels on the card, its plain "
        "version on the CPU; prompts of 8-119 tokens, buckets 16 and 128, the latter "
        "past the dropless limit of 64)")
    release()
    for arch in ("arctic-480b", "deepseek-v2-236b"):
        cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
        p_gpu = serve.init_params(cfg, seed=3, device="cuda")
        p_cpu = Transformer(cfg, device="cpu")
        p_cpu.load_state_dict(p_gpu.state_dict())
        out = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            pack.launches = 0
            engine = ServingEngine(cfg, params, max_slots=4, max_len=256,
                                   bucketing=(16, 128), device=dev)
            reqs = serve.make_requests(cfg, 6, max_new=8, seed=2, min_len=8, max_len=120)
            out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
            if dev == "cuda" and pack.launches == 0:
                fail(f"{cfg.name} on the card never launched stream_pack")
        say(f"  {cfg.name} greedy tokens cuda: {out['cuda']}")
        say(f"  {cfg.name} greedy tokens cpu:  {out['cpu']}")
        if out["cuda"] != out["cpu"]:
            fail(f"{cfg.name}: greedy tokens differ between the card and the CPU")


# the batch decode of phases 12-14: sequences, steps, and prompt length of the
# full-sequence forward
DECODE_BATCH, DECODE_STEPS, FORWARD_LEN = 4, 16, 512


def _load(arch: str, number: int):
    """``arch`` at full width and depth, bf16, random weights drawn on the
    card from seed 0, after the memory of the phases before is collected."""
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve

    release()
    cfg = dataclasses.replace(C.get(arch), dtype="bfloat16")
    t0 = time.perf_counter()
    model = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in model.parameters())
    say(f"== phase {number}: {arch}, full width, {cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers else "")
        + f", bf16, on the card: {n / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, model


def _tokens(cfg, *shape, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int64)).cuda()


def _clone(tree):
    import torch
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _restore(cache, snapshot) -> None:
    from torch.utils import _pytree as pytree

    for dst, src in zip(pytree.tree_leaves(cache), pytree.tree_leaves(snapshot)):
        dst.copy_(src)


def timed_forward(model, cfg, batch, label: str, want_flash: int) -> dict:
    """One ``forward`` on the card: finite logits of the right shape, the
    flash kernel launched ``want_flash`` times (the wrapper's count); then
    its time (CUDA events, mean of 3) and the device time of one call by
    kernel (torch.profiler), B1's share among them."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import forward

    before = flash.launches
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, _ = forward(model, batch, cfg)
        torch.cuda.synchronize()
    made = flash.launches - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    S = logits.shape[1]
    if logits.shape[-1] != cfg.padded_vocab or not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits {tuple(logits.shape)} not finite or not of width {cfg.padded_vocab}")
    if made != want_flash:
        fail(f"{label}: the flash kernel launched {made} times, want {want_flash}")
    del logits
    with torch.no_grad():
        ms = time_ms(lambda: forward(model, batch, cfg), 3, warmup=1)
        rows = by_kernel(kernels_in_one(lambda: forward(model, batch, cfg)[0], check=False))
    total = sum(us for us, _, _ in rows) or float("nan")
    fl_us = sum(us for us, _, key in rows if "flash_fwd" in key)
    fl = sum(c for _, c, key in rows if "flash_fwd" in key)
    say(f"{label}: logits (.., {S}, {cfg.padded_vocab}) finite; {made} flash launches; "
        f"{ms:.3f} ms per call (CUDA events), peak {peak:.2f} GiB; one call "
        f"{total / 1e3:.3f} ms of kernels, "
        f"{fl} flash_fwd {fl_us / 1e3:.3f} ms ({fl_us / total:.1%}); top:")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    return dict(ms=ms, flash=made, flash_ms=fl_us / 1e3, kernels_ms=total / 1e3, peak_gib=peak)


def batch_decode(model, cfg, make_cache, first, label: str, want_flash_per_step: int) -> dict:
    """``DECODE_STEPS`` greedy steps of ``decode_step`` over a batch, run
    eagerly and then as one captured CUDA graph of a step replayed (its
    token input fed from its own output), each from the state
    ``make_cache()`` gives: both must give the same tokens, in range.
    Then one replay's kernels (torch.profiler), which must hold
    ``want_flash_per_step`` flash kernels.  Returns the times and counts."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import decode_step

    def step(cache, tok):
        logits, _ = decode_step(model, cache, tok, cfg)
        return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)

    before = flash.launches
    with torch.no_grad():
        cache, tok, eager = make_cache(), first.clone(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            nxt = step(cache, tok)
            eager.append(nxt)
            tok = nxt[:, None]
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
        eager = torch.stack(eager, 1).cpu()

        cache = make_cache()
        snapshot = _clone(cache)
        tok_in = first.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(cache, tok_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        _restore(cache, snapshot)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(cache, tok_in)
        got = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DECODE_STEPS):
            graph.replay()
            got.append(out.clone())
            tok_in.copy_(out[:, None])
        stop.record()
        stop.synchronize()
        replay_ms = start.elapsed_time(stop) / DECODE_STEPS
        got = torch.stack(got, 1).cpu()
    launches = flash.launches - before
    say(f"{label}: {DECODE_STEPS} greedy steps of {first.shape[0]} sequences: eager "
        f"{eager_ms:.3f} ms a step (host clock), graph replay {replay_ms:.3f} ms a step "
        f"(CUDA events, with the token feed); {launches} flash launches (eager steps, "
        f"warm-up, capture)")
    say(f"  tokens eager {eager.tolist()}")
    say(f"  tokens graph {got.tolist()}")
    if not torch.equal(eager, got):
        fail(f"{label}: the captured step gives other tokens than the eager one")
    if eager.min() < 0 or eager.max() >= cfg.vocab:
        fail(f"{label}: a token outside [0, {cfg.vocab})")
    if launches != (DECODE_STEPS + 2) * want_flash_per_step:
        fail(f"{label}: {launches} flash launches, want "
             f"{(DECODE_STEPS + 2) * want_flash_per_step}")

    # one replay from a fixed state, profiled: its outputs must come back
    mid = _clone(cache)
    tok_mid = tok_in.clone()

    def replay():
        _restore(cache, mid)
        tok_in.copy_(tok_mid)
        graph.replay()
        return out

    rows = by_kernel(kernels_in_one(replay))
    if not rows:
        fail(f"{label}: the profiler saw no device time in a decode replay")
    total = sum(us for us, _, _ in rows)
    fl = sum(c for _, c, key in rows if "flash_fwd" in key)
    say(f"  one decode replay (after the copies that restore its state): "
        f"{sum(c for _, c, _ in rows)} device ops, {total / 1e3:.3f} ms of kernels, "
        f"{fl} flash_fwd; top:")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    if fl != want_flash_per_step:
        fail(f"{label}: a decode replay ran {fl} flash kernels, want {want_flash_per_step}")
    return dict(eager_step_ms=eager_ms, replay_ms=replay_ms, flash_launches=launches,
                flash_in_replay=fl, replay_kernels_ms=total / 1e3)


def phase_vlm(number: int) -> dict:
    """llava-next-34b at full width, 4 of its 60 layers: (i) served through
    ``ServingEngine`` (text prompts, as in JAX) with CUDA-graph-sealed
    steps, one prefill replay profiled (one flash kernel per layer); (ii)
    one ``forward`` of 2880 vision embeddings and a 64-token prompt, B1 at
    S = 2944, GQA 7."""
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as flash

    say(f"== phase {number}: serve llava-next-34b, full width, 4 layers, bf16, on the card")
    release()
    cfg = dataclasses.replace(C.get("llava-next-34b"), n_layers=4, dtype="bfloat16")
    engine, (_, served, copies) = serve_on_card(cfg)
    st = engine.stats
    if served != 2 * cfg.n_layers * st.prefill_compiles or copies:
        fail(f"flash launched {served} times for {st.prefill_compiles} captured prefill "
             f"buckets (want {2 * cfg.n_layers * st.prefill_compiles}), {copies} layout copies")
    in_replay = step_breakdown(engine)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": _tokens(cfg, 1, 64, seed=5),
             "vision_embeds": torch.randn((1, cfg.vision_tokens, cfg.vision_dim), generator=g,
                                          device="cuda").to(torch.bfloat16)}
    flash.launches = 0
    fwd = timed_forward(engine.params, cfg, batch,
                        f"forward: {cfg.vision_tokens} vision embeddings + 64 tokens",
                        cfg.n_layers)
    return dict(served_launches=served, forward_launches=fwd["flash"],
                flash_in_replays=in_replay or 0, profiled_replays=0 if in_replay is None else 1,
                forward=fwd)


def phase_audio(number: int) -> dict:
    """seamless-m4t-medium at full width and depth: ``encode_memory`` on
    frames at the config's ratio (B1 bidirectional, hd 64), the
    teacher-forced ``forward``, then the batch decode with the memory in
    the cache (cross attention on B1 with one query row)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import encode_memory, init_cache

    cfg, model = _load("seamless-m4t-medium", number)
    B, S = DECODE_BATCH, FORWARD_LEN
    T = S // cfg.audio_frames_ratio
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = torch.randn((B, T, cfg.audio_dim), generator=g, device="cuda")
    flash.launches = 0                                     # the path's run starts here
    with torch.no_grad():
        memory = encode_memory(model, frames, cfg)
        torch.cuda.synchronize()
    if memory.shape != (B, T, cfg.d_model) or not bool(torch.isfinite(memory).all()):
        fail(f"memory {tuple(memory.shape)} not finite or not ({B}, {T}, {cfg.d_model})")
    enc = flash.launches
    with torch.no_grad():
        enc_ms = time_ms(lambda: encode_memory(model, frames, cfg), 3, warmup=1)
    say(f"encode_memory: frames ({B}, {T}, {cfg.audio_dim}) -> memory finite, {enc} flash "
        f"launches (bidirectional), {enc_ms:.3f} ms per call (CUDA events)")
    if enc != cfg.n_enc_layers:
        fail(f"encode_memory launched the flash kernel {enc} times for {cfg.n_enc_layers} layers")
    flash.launches = 0
    fwd = timed_forward(model, cfg, {"tokens": _tokens(cfg, B, S, seed=6), "frames": frames},
                        f"teacher-forced forward ({B} x {S} tokens over {T} frames)",
                        cfg.n_enc_layers + 2 * cfg.n_layers)

    def make_cache():
        cache = init_cache(cfg, B, 64, memory_len=T, device="cuda")
        cache["memory"].copy_(memory)
        return cache

    flash.launches = 0
    dec = batch_decode(model, cfg, make_cache, _tokens(cfg, B, 1, seed=7),
                       "batch decode with the memory in the cache", cfg.n_layers)
    return dict(launches=enc + fwd["flash"] + dec["flash_launches"], encode_ms=enc_ms,
                forward=fwd, decode=dec)


def phase_recurrent(arch: str, number: int) -> dict:
    """zamba2-2.7b (hybrid) or xlstm-125m (ssm) at full width and depth:
    ``forward`` on ``DECODE_BATCH`` prompts of ``FORWARD_LEN`` tokens (the
    chunked SSD or mLSTM; zamba2's shared block on B1 at hd 80), then the
    batch decode from an empty state."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import init_cache

    cfg, model = _load(arch, number)
    B, S = DECODE_BATCH, FORWARD_LEN
    apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    if cfg.ssm:
        say(f"Mamba2: d_inner {cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.state_dim}, "
            f"chunk {cfg.ssm.chunk}; shared attention block after every "
            f"{cfg.hybrid_attn_every}th layer ({apps} applications), "
            f"{cfg.n_heads} heads of {cfg.resolved_head_dim}")
    else:
        say(f"xLSTM: sLSTM at layers {cfg.xlstm.slstm_at}, mLSTM elsewhere (chunk "
            f"{cfg.xlstm.mlstm_chunk}), {cfg.n_heads} heads")
    flash.launches = 0                                     # the path's run starts here
    fwd = timed_forward(model, cfg, {"tokens": _tokens(cfg, B, S, seed=8)},
                        f"forward ({B} x {S} tokens)", apps)
    dec = batch_decode(model, cfg, lambda: init_cache(cfg, B, 64, device="cuda"),
                       _tokens(cfg, B, 1, seed=9), "batch decode from an empty state", 0)
    return dict(launches=fwd["flash"] + dec["flash_launches"], forward=fwd, decode=dec)


@contextlib.contextmanager
def b1_calls(seen: set):
    """Add to ``seen`` the shape of every call of B1's model-layout entry
    (``kernel.attention``, which every model path calls) as (dtype, B, q
    heads, kv heads, Sq, Skv, hd, causal, scale, softcap, window); the
    calls and the wrapper's count are otherwise unchanged."""
    from repro_torch.kernels.flash_attention import kernel

    inner = kernel.attention

    def recording(q, k, v, *, scale=None, softcap=0.0, causal=True, window=0, **kw):
        seen.add((str(q.dtype)[6:], q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                  k.shape[1], q.shape[3], bool(causal),
                  float(scale if scale is not None else 1.0 / math.sqrt(q.shape[3])),
                  float(softcap), int(window or 0)))
        return inner(q, k, v, scale=scale, softcap=softcap, causal=causal, window=window, **kw)

    kernel.attention = recording
    try:
        yield seen
    finally:
        kernel.attention = inner


def check_family_launches(seen: set) -> None:
    """Fails unless every B1 call of phases 11-14 (:func:`b1_calls`) was at
    a shape that phase 3 held against the plain version
    (:func:`family_cases`: the same dtype, batch, heads, lengths, head dim
    and mask, default scale, no cap, no window)."""
    checked = {(dname, B, kv * group, kv, Sq, Skv, hd, causal, 1.0 / math.sqrt(hd), 0.0, 0)
               for dname, B, hd, kv, group, Sq, Skv, causal in family_cases()}
    unchecked = sorted(seen - checked)
    if unchecked:
        fail(f"phases 11-14 launched B1 at shapes phase 3 never checked: {unchecked}")
    say(f"phases 11-14 called B1 at {len(seen)} shapes (dtype, B, heads, kv heads, Sq, Skv, "
        f"hd, causal), each held against the plain version in phase 3: "
        + "; ".join(" ".join(map(str, key[:8])) for key in sorted(seen)))


# forward logits of the smoke configs, card against CPU at float32 (atol,
# rtol): the two differ only in summation order (B1's float32 kernel and
# cuBLAS against the CPU's plain attention and GEMMs, TF32 off)
FAMILY_FORWARD_TOL = (1e-4, 1e-4)


def phase_families_cpu_parity(number: int) -> None:
    """The four new families' smoke configs at float32, one set of weights
    (drawn on the card, copied to the CPU): ``forward`` logits of
    ``DECODE_BATCH`` x 16 tokens (with vision embeddings or frames) within
    :data:`FAMILY_FORWARD_TOL` of the CPU's, B1 inside the model on the card
    (vlm, audio, hybrid: the shared block); then llava-next's engine on text
    prompts, and eight greedy batch-decode steps of the other three (the
    audio memory encoded on each device), identical on card and CPU."""
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch import serve
    from repro_torch.models import (Transformer, decode_step, encode_memory, forward,
                                    init_cache)
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: card against CPU, llava-next, seamless, zamba2 and xlstm smoke "
        "configs, float32 (forward logits within tolerance, identical greedy tokens; B1 on "
        "the card in the forwards, the vlm prefill and the audio cross attention, its plain "
        "version on the CPU)")
    release()
    for arch in ("llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b", "xlstm-125m"):
        cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
        p_gpu = serve.init_params(cfg, seed=4, device="cuda")
        p_cpu = Transformer(cfg, device="cpu")
        p_cpu.load_state_dict(p_gpu.state_dict())
        frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (DECODE_BATCH, 4, max(cfg.audio_dim, 1)), dtype=np.float32))
        first = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (DECODE_BATCH, 1)))
        rng = np.random.default_rng(7)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, 16)))}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
                (DECODE_BATCH, cfg.vision_tokens, cfg.vision_dim), dtype=np.float32))
        if cfg.family == "audio":
            batch["frames"] = frames
        logits = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            flash.launches = 0
            with torch.no_grad():
                logits[dev] = forward(params, {k: t.to(dev) for k, t in batch.items()},
                                      cfg)[0].cpu()
            if dev == "cuda" and cfg.family != "ssm" and not flash.launches:
                fail(f"{cfg.name}: forward on the card never launched the flash kernel")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        r = ratio(logits["cuda"], logits["cpu"], *FAMILY_FORWARD_TOL)
        say(f"  {cfg.name} forward logits {tuple(logits['cpu'].shape)}: card against CPU "
            f"max_abs_err {err:.3e} ({r:.2f} of tolerance {FAMILY_FORWARD_TOL}), max |logit| "
            f"{logits['cpu'].abs().max().item():.3e}")
        if not (bool(torch.isfinite(logits["cuda"]).all()) and r <= 1.0):
            fail(f"{cfg.name}: forward logits on the card differ from the CPU's")
        out = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            flash.launches = 0
            if cfg.family == "vlm":
                engine = ServingEngine(cfg, params, max_slots=4, max_len=128,
                                       bucketing=(16, 64), device=dev)
                reqs = serve.make_requests(cfg, 6, max_new=8, seed=2, min_len=4, max_len=60)
                out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
            else:
                with torch.no_grad():
                    cache = init_cache(cfg, DECODE_BATCH, 16, memory_len=frames.shape[1],
                                       device=dev)
                    if cfg.family == "audio":
                        cache["memory"].copy_(encode_memory(params, frames.to(dev), cfg))
                    tok, toks = first.to(dev), []
                    for _ in range(8):
                        logits, _ = decode_step(params, cache, tok, cfg)
                        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
                        toks.append(tok[:, 0].tolist())
                out[dev] = toks
            if dev == "cuda" and cfg.family in ("vlm", "audio") and not flash.launches:
                fail(f"{cfg.name} on the card never launched the flash kernel")
        say(f"  {cfg.name} greedy tokens cuda: {out['cuda']}")
        say(f"  {cfg.name} greedy tokens cpu:  {out['cpu']}")
        if out["cuda"] != out["cpu"]:
            fail(f"{cfg.name}: greedy tokens differ between the card and the CPU")


# the control plane's lanes (phases 16-18): the served phases' slots,
# positions and buckets
LANE_ENGINE = dict(max_slots=SERVE_SLOTS, max_len=1024,
                   bucketing=f"pow2:{min(PREFILL_BUCKETS)}:{max(PREFILL_BUCKETS)}")
# a dense lane's latency target (ms): generous, so admission refuses nothing
DENSE_TARGET_MS = 60_000.0


def lane_requests(cfg, n: int, seed: int, max_new: int = 16, min_len: int = 20,
                  max_len: int = 501) -> list:
    """(prompt, max_new_tokens) pairs: ``serve.make_requests``'s prompts."""
    from repro_torch.launch import serve

    return [(r.prompt, r.max_new_tokens) for r in serve.make_requests(
        cfg, n, max_new=max_new, seed=seed, min_len=min_len, max_len=max_len)]


def direct_tokens(engine, work: list) -> list:
    """Greedy tokens of ``work`` ((prompt, max_new) pairs) from ``engine``
    driven directly by ``run_until_drained``, in order."""
    from repro_torch.serving import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(work)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [list(r.generated) for r in reqs]


def percentile_ms(values) -> str:
    import numpy as np

    if not values:
        return "p50 - p99 -"
    v = np.asarray(values) * 1e3
    return f"p50 {np.percentile(v, 50):.2f}ms p99 {np.percentile(v, 99):.2f}ms"


def device_busy(events, wall_s: float) -> float:
    """Share of ``wall_s`` in which at least one device kernel ran: the
    union of the profiler's kernel intervals over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6 / wall_s if wall_s > 0 else 0.0


def class_report(disp, lanes: dict, done: dict, before: dict) -> None:
    """Per class: TTFT p50/p99 over the finished requests, decode tok/s of
    the lane's engine over the run, grants, preemptions, sheds."""
    snap = disp.snapshot()
    classes = snap.get("classes", {})
    for name, (cls, engine) in lanes.items():
        reqs = done.get(name, [])
        st = engine.stats
        toks = st.tokens_out - before[name][0]
        secs = st.decode_s - before[name][1]
        c = classes.get(cls, classes.get(str(cls), {}))
        say(f"  class {cls} [{name}]: {len(reqs)} requests, TTFT "
            f"{percentile_ms([r.t_first - r.t_submit for r in reqs])}, decode "
            f"{toks / secs if secs else 0.0:.1f} tok/s, grants "
            f"{c.get('grant_ms', {}).get('count', 0)}, preemptions {c.get('preemptions', 0)}, "
            f"shed {c.get('shed', 0)}")


def dispatched_burst(disp, work: dict, *, profile_it: bool = False) -> dict:
    """Submit ``work`` ({lane: [(prompt, max_new), ...]}) interleaved across
    lanes, wait for every future; returns the finished requests by lane (in
    submission order), the wall time and, with ``profile_it``, the device
    kernels the profiler saw during the burst."""
    import contextlib as _cl

    import torch
    from torch.profiler import ProfilerActivity, profile

    order = []
    for i in range(max(len(w) for w in work.values())):
        for lane, w in work.items():
            if i < len(w):
                order.append((lane, w[i]))
    ctx = profile(activities=[ProfilerActivity.CUDA]) if profile_it else _cl.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        futs = [(lane, disp.submit(lane, p, max_new_tokens=n)) for lane, (p, n) in order]
        done: dict = {lane: [] for lane in work}
        for lane, f in futs:
            done[lane].append(f.result(timeout=600))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []
    if profile_it:
        events = [e for e in prof.events()
                  if "cuda" in str(getattr(e, "device_type", "")).lower()]
    return {"done": done, "wall_s": wall, "events": events}


def check_lane(name: str, reqs: list, cfg, want: list | None = None, prefix: int = 0) -> None:
    """Every request finished without error with tokens in range; with
    ``want``, each request's tokens (their first ``prefix`` if given) equal
    the direct engine's."""
    import numpy as np

    for i, r in enumerate(reqs):
        if r.error or not (len(r.generated) == r.max_new_tokens or r.truncated):
            fail(f"{name} request {i}: {len(r.generated)} tokens, error {r.error}")
        toks = np.asarray(r.generated)
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"{name} request {i}: token outside [0, {cfg.vocab})")
        if want is not None:
            got = list(r.generated)[:prefix] if prefix else list(r.generated)
            if got != want[i]:
                fail(f"{name} request {i}: dispatched tokens {got} differ from the "
                     f"direct engine's {want[i]}")


def phase_dispatch(number: int) -> dict:
    """The in-process ``AsyncDispatcher`` over the port's engines on the
    card: a dense lane (phi4-mini at full width and depth, class 0, a
    latency target) and a MoE lane (deepseek-v2 at full width, 2 layers,
    class 1), bf16, one shared schedule cache; a burst of 16 mixed requests
    under per-engine steppers (profiled) and under a pool of two; then a
    third lane (phi4-mini smoke, float32, a schedule cache of one entry)
    registered while the two serve, whose requests force one evict and
    re-seal on its stepper while the others replay."""
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.core.capture import CAPTURE_LOCK
    from repro_torch.dispatch import AsyncDispatcher, ScheduleCache
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: AsyncDispatcher on the card: phi4-mini-3.8b (full, class 0, "
        f"target {DENSE_TARGET_MS:.0f}ms) + deepseek-v2-236b (full width, 2 layers, class 1), "
        "bf16; per-engine, then pool of 2; a third lane registered while they serve")
    release()
    dense_cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    moe_cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=2, dtype="bfloat16")
    cache = ScheduleCache(capacity=64)
    pack.launches = flash.launches = 0                  # the path's run starts here
    t0 = time.perf_counter()
    dense = ServingEngine(dense_cfg, serve.init_params(dense_cfg, seed=0, device="cuda"),
                          schedule_cache=cache, device="cuda", **LANE_ENGINE)
    moe = ServingEngine(moe_cfg, serve.init_params(moe_cfg, seed=0, device="cuda"),
                        schedule_cache=cache, device="cuda", **LANE_ENGINE)
    say(f"two lanes built and sealed in {time.perf_counter() - t0:.2f}s")
    dense_work = lane_requests(dense_cfg, 8, seed=10)
    moe_work = lane_requests(moe_cfg, 8, seed=11)
    want = direct_tokens(dense, dense_work)          # the same engine, driven directly
    lanes = {"phi4-mini": (0, dense), "deepseek-v2": (1, moe)}
    out: dict = {}

    def burst(mode: str, profiled: bool) -> dict:
        disp = AsyncDispatcher(stepping=mode, pool_size=2, max_pending=1000)
        disp.register_model("phi4-mini", dense, priority_class=0,
                            latency_target_ms=DENSE_TARGET_MS)
        disp.register_model("deepseek-v2", moe, priority_class=1)
        before = {n: (e.stats.tokens_out, e.stats.decode_s) for n, (_, e) in lanes.items()}
        replays0 = {n: (e.stats.prefill_replays, e.stats.decode_replays)
                    for n, (_, e) in lanes.items()}
        cache0 = cache.stats.as_dict()
        with disp:
            res = dispatched_burst(disp, {"phi4-mini": dense_work, "deepseek-v2": moe_work},
                                   profile_it=profiled)
            builds = disp.builds_by_stepper
        cache1 = cache.stats.as_dict()
        check_lane("phi4-mini", res["done"]["phi4-mini"], dense_cfg, want)
        check_lane("deepseek-v2", res["done"]["deepseek-v2"], moe_cfg)
        same = [list(r.generated) for r in res["done"]["deepseek-v2"]] == moe_want
        say(f"{mode}{' (profiled)' if profiled else ''}: 16 requests in {res['wall_s']:.3f}s; "
            f"phi4-mini tokens identical to the direct engine's (8 requests, bf16); "
            f"deepseek-v2 8 complete with "
            f"{sum(len(r.generated) for r in res['done']['deepseek-v2'])} tokens (same as the "
            f"direct engine's: {'yes' if same else 'no'}, not required); builds on steppers "
            f"{builds}; cache hits {cache1['hits'] - cache0['hits']}, misses "
            f"{cache1['misses'] - cache0['misses']}, evictions "
            f"{cache1['evictions'] - cache0['evictions']}")
        class_report(disp, lanes, res["done"], before)
        if any(builds.values()):
            fail(f"{mode}: a stepper sealed a step on the steady path: {builds}")
        res["pre"] = {n: e.stats.prefill_replays - replays0[n][0] for n, (_, e) in lanes.items()}
        res["dec"] = {n: e.stats.decode_replays - replays0[n][1] for n, (_, e) in lanes.items()}
        return res

    moe_want = direct_tokens(moe, moe_work)
    for mode in ("per-engine", "pool"):
        out[f"wall_{mode}"] = burst(mode, False)["wall_s"]
    # the kernels the profiler sees while the lanes serve: a session counts
    # only if it saw exactly the B1 and B2 kernels the burst's replays
    # imply (an H100 session has come back empty, another with 25 of a
    # replay's 295 kernels), and only such a session gives the busy share
    for attempt in range(1, 4):
        res = burst("per-engine", True)
        rows = by_kernel(res["events"])
        fl = sum(c for _, c, key in rows if "flash_fwd" in key)
        b2 = sum(c for _, c, key in rows if "stream_pack_" in key)
        pre, dec = res["pre"], res["dec"]
        want_fl = dense_cfg.n_layers * pre["phi4-mini"]
        want_b2 = 3 * moe_cfg.n_layers * (pre["deepseek-v2"] + dec["deepseek-v2"])
        whole = fl == want_fl and b2 == want_b2
        busy = device_busy(res["events"], res["wall_s"])
        say(f"  profiled burst {attempt}: {sum(c for _, c, _ in rows)} device kernels; flash_fwd "
            f"{fl} (want {want_fl}: {dense_cfg.n_layers} x {pre['phi4-mini']} prefill replays), "
            f"stream_pack {b2} (want {want_b2}: 3 x {moe_cfg.n_layers} x "
            f"{pre['deepseek-v2'] + dec['deepseek-v2']} replays)"
            + (f"; device busy {busy:.1%} of the burst's wall time" if whole else
               ": not the kernels the replays imply, profiling again"))
        if whole:
            break
    else:
        fail(f"no profiled burst of three saw exactly the kernels its replays imply: "
             f"flash_fwd {fl} (want {want_fl}), stream_pack {b2} (want {want_b2})")
    if not want_fl or not want_b2:
        fail(f"the dispatched lanes ran {want_fl} flash_fwd and {want_b2} stream_pack kernels "
             "in their replays: both kernels must run inside the lanes")
    out.update(flash_in_replays=fl, b2_in_replays=b2, busy=busy,
               profiled_replays=sum(pre.values()) + sum(dec.values()))

    # a third lane registered while the two serve: its seal captures CUDA
    # graphs on this thread while the steppers replay; its schedule cache
    # of one entry evicts prefill bucket 16 while it seals bucket 64, so
    # its first request re-seals bucket 16 on its stepper
    smoke_cfg = dataclasses.replace(C.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    smoke_params = serve.init_params(smoke_cfg, seed=5, device="cuda")
    smoke_work = lane_requests(smoke_cfg, 6, seed=12, max_new=8, min_len=4, max_len=17)
    long_work = {"phi4-mini": [(p, 48) for p, _ in dense_work],
                 "deepseek-v2": [(p, 48) for p, _ in moe_work]}
    disp = AsyncDispatcher(stepping="per-engine", max_pending=1000)
    disp.register_model("phi4-mini", dense, priority_class=0, latency_target_ms=DENSE_TARGET_MS)
    disp.register_model("deepseek-v2", moe, priority_class=1)
    with disp:
        futs = [(lane, disp.submit(lane, p, max_new_tokens=n))
                for i in range(8) for lane, w in long_work.items() for p, n in [w[i]]]
        time.sleep(0.05)
        steps0 = dense.stats.steps + moe.stats.steps
        lock0 = CAPTURE_LOCK.stats()
        t0 = time.perf_counter()
        small = ScheduleCache(capacity=1)
        smoke = ServingEngine(smoke_cfg, smoke_params, max_slots=4, max_len=128,
                              bucketing=(16, 64), schedule_cache=small, device="cuda")
        disp.register_model("phi4-smoke", smoke, priority_class=0)
        reg_s = time.perf_counter() - t0
        steps1 = dense.stats.steps + moe.stats.steps
        lock1 = CAPTURE_LOCK.stats()
        sfuts = [disp.submit("phi4-smoke", p, max_new_tokens=n) for p, n in smoke_work]
        smoke_done = [f.result(timeout=600) for f in sfuts]
        done: dict = {"phi4-mini": [], "deepseek-v2": []}
        for lane, f in futs:
            done[lane].append(f.result(timeout=600))
        steps2 = dense.stats.steps + moe.stats.steps
        builds = disp.builds_by_stepper
    check_lane("phi4-mini", done["phi4-mini"], dense_cfg, want, prefix=16)
    check_lane("deepseek-v2", done["deepseek-v2"], moe_cfg)
    check_lane("phi4-smoke", smoke_done, smoke_cfg)
    say(f"third lane registered in {reg_s:.3f}s while the two served (their steps: {steps0} "
        f"before, {steps1} after the registration, {steps2} at the end); capture lock: "
        f"{lock1['captures'] - lock0['captures']} captures waited "
        f"{(lock1['capture_wait_s'] - lock0['capture_wait_s']) * 1e3:.2f}ms in all for replays "
        f"in flight; phi4-mini's first 16 tokens of 48 identical to the direct engine's")
    if steps2 <= steps1 or steps1 < steps0:
        fail("the two lanes did not keep stepping around the third lane's registration")
    # the host time of one uncontended shared section, which every serving
    # step's device sections pay (Nimble's graph launches take none)
    t0 = time.perf_counter()
    for _ in range(100_000):
        with CAPTURE_LOCK.replaying():
            pass
    out["shared_section_us"] = (time.perf_counter() - t0) * 10
    say(f"capture lock: one uncontended shared section takes {out['shared_section_us']:.3f} us "
        "of host time (mean of 100000)")
    say(f"forced re-seal: the one-entry cache evicted {small.stats.evictions} and built "
        f"{small.stats.builds} steps; builds on steppers {builds}")
    if builds.get("phi4-smoke") != 1 or any(v for k, v in builds.items() if k != "phi4-smoke"):
        fail(f"want exactly one build, on the third lane's stepper (the forced re-seal): {builds}")
    out["b2_launches"], out["flash_launches"] = pack.launches, flash.launches  # ... and ends here
    say(f"wrapper calls over the phase (the lanes' seals: eager warm-up runs and captures): "
        f"flash {flash.launches}, stream_pack {pack.launches}")
    if not flash.launches or not pack.launches:
        fail("a kernel of the dispatched path was never launched")

    # the dispatched float32 case of the card-against-CPU checks: the third
    # lane's requests through an AsyncDispatcher on the CPU, same weights
    from repro_torch.models import Transformer

    p_cpu = Transformer(smoke_cfg, device="cpu")
    p_cpu.load_state_dict(smoke_params.state_dict())
    cpu_engine = ServingEngine(smoke_cfg, p_cpu, max_slots=4, max_len=128,
                               bucketing=(16, 64), device="cpu")
    with AsyncDispatcher(stepping="per-engine") as cpu_disp:
        cpu_disp.register_model("phi4-smoke", cpu_engine)
        cpu_done = [f.result(timeout=600) for f in
                    [cpu_disp.submit("phi4-smoke", p, max_new_tokens=n) for p, n in smoke_work]]
    card, cpu = [list(r.generated) for r in smoke_done], [list(r.generated) for r in cpu_done]
    say(f"dispatched phi4-mini smoke, float32: card {card}")
    say(f"                                    cpu  {cpu}")
    if card != cpu:
        fail("the dispatched smoke lane's tokens differ between the card and the CPU")
    return out


def lane_spec():
    """The worker plane's and the journal's recipe: phi4-mini at full width
    and depth, bf16, seed 0, the served phases' slots and buckets."""
    from repro_torch.serving import ServingEngineSpec

    return ServingEngineSpec(arch="phi4-mini-3.8b", smoke=False, dtype="bfloat16", seed=0,
                             device="cuda", **LANE_ENGINE)


def phase_workers(number: int) -> dict:
    """``stepping="workers"``: one spawned worker process on ``cuda:0``
    builds phi4-mini from :func:`lane_spec`; its tokens must equal an
    in-process engine's built from the same spec.  Then the worker is
    SIGKILLed during a step: the requests in flight fail ``WorkerCrashed``,
    the queued ones replay on the respawned worker, token-identical."""
    import os
    import signal

    import repro_torch.configs as C
    from repro_torch.dispatch import (AsyncDispatcher, WorkerCrashed, WorkerPlane,
                                      WorkerSetupError)

    say(f"== phase {number}: the worker plane on the card: one spawned worker, phi4-mini "
        "full width, bf16, from ServingEngineSpec(smoke=False, seed=0)")
    release()
    try:
        WorkerPlane(1, device="cuda", start_method="fork").start()
        fail("a fork worker plane started after CUDA was initialised here")
    except WorkerSetupError as exc:
        say(f"fork after CUDA init refused: {exc}")
    spec = lane_spec()
    cfg = dataclasses.replace(C.get(spec.arch), dtype=spec.dtype)
    t0 = time.perf_counter()
    ref_engine = spec.build(0)
    say(f"in-process engine from the spec: {time.perf_counter() - t0:.2f}s")
    work = lane_requests(cfg, 8, seed=20)
    long_work = [(p, 400) for p, _ in lane_requests(cfg, 4, seed=21, max_len=300)]
    want = direct_tokens(ref_engine, work)

    plane = WorkerPlane(1, device="cuda", start_method="spawn", hb_interval=0.2,
                        hb_timeout=60.0, step_timeout=300.0, setup_timeout=600.0)
    disp = AsyncDispatcher(stepping="workers", worker_plane=plane, max_pending=1000)
    disp.register_model("phi4-mini", spec)
    t0 = time.perf_counter()
    out = {}
    with disp:
        ready_s = time.perf_counter() - t0
        w = disp.snapshot()["async"]["workers"]["workers"][0]
        say(f"worker pid {w['pid']} on device {w['device']} up in {ready_s:.2f}s "
            f"(spawn to ready {w['spawn_s']:.2f}s, engine build and seal {w['register_s']:.2f}s)")
        res = dispatched_burst(disp, {"phi4-mini": work})
        check_lane("phi4-mini", res["done"]["phi4-mini"], cfg, want)
        say(f"8 requests through the worker in {res['wall_s']:.3f}s: tokens identical to the "
            "in-process engine's")
        long_futs = [disp.submit("phi4-mini", p, max_new_tokens=n) for p, n in long_work]
        queued = [disp.submit("phi4-mini", p, max_new_tokens=n) for p, n in work[:4]]
        time.sleep(0.5)
        pid = disp.snapshot()["async"]["workers"]["workers"][0]["pid"]
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        crashed = 0
        for f in long_futs:
            try:
                f.result(timeout=600)
            except WorkerCrashed:
                crashed += 1
        replayed = [f.result(timeout=600) for f in queued]
        replay_s = time.perf_counter() - t_kill
        check_lane("phi4-mini (replayed)", replayed, cfg, want[:4])
        w = disp.snapshot()["async"]["workers"]["workers"][0]
        out["launches"] = w["stats"].get("kernel_launches", {})
        say(f"SIGKILL of pid {pid} during a step: {crashed} of 4 requests in flight failed "
            f"WorkerCrashed; the 4 queued replayed token-identical on pid {w['pid']} "
            f"({w['restarts']} restart); kill to last replayed token {replay_s:.2f}s "
            f"(respawn: spawn to ready {w['spawn_s']:.2f}s, rebuild and seal "
            f"{w['register_s']:.2f}s)")
        if crashed < 1 or w["restarts"] < 1 or w["pid"] == pid:
            fail("the kill did not crash in-flight work or the worker did not respawn")
        say(f"the worker's wrapper calls (its seals): {out['launches']}")
        if not out["launches"].get("flash_attention"):
            fail("the worker never launched the flash kernel")
    if plane.leaked():
        fail(f"worker processes outlived the plane: {plane.leaked()}")
    out.update(plane=plane, spec=spec, cfg=cfg, work=work, want=want,
               spawn_s=ready_s, respawn_s=replay_s)
    return out


def phase_journal(number: int, workers: dict) -> dict:
    """A journaled in-process run of phi4-mini (the lane's spec journaled)
    stopped with work in flight; a fresh dispatcher ``recover()``s it on
    the card — the lane rebuilt from its spec, the unfinished requests
    replayed token-identical; the recovered run's Chrome trace validates,
    and a metrics registry exposes the dispatch, cache, worker-plane and
    tracer families."""
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.dispatch import AsyncDispatcher, RequestJournal
    from repro_torch.kernels.flash_attention import kernel as flash

    say(f"== phase {number}: journal and recovery on the card, trace export, metrics registry")
    release()
    spec, cfg, work, want = workers["spec"], workers["cfg"], workers["work"], workers["want"]
    want_by_prompt = {tuple(int(t) for t in p): w for (p, _), w in zip(work, want)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    path = f"{tmp}/journal.db"
    journal = RequestJournal(path, flush_interval=0.01)
    disp = AsyncDispatcher(stepping="per-engine", journal=journal, max_pending=1000)
    disp.register_model("phi4-mini", spec.build(0), spec=spec)
    disp.start()
    for p, n in work:
        disp.submit("phi4-mini", p, max_new_tokens=n)
    time.sleep(0.05)
    disp.stop(drain=False)                 # the crash: work left in flight
    journal.sync(timeout=10.0)
    journal.close()
    del disp
    release()

    tracer = obs.get_tracer()
    tracer.clear()
    tracer.enable()
    flash.launches = 0                      # the recovery path's run starts here
    t0 = time.perf_counter()
    journal = RequestJournal(path, flush_interval=0.01)
    disp = AsyncDispatcher(stepping="per-engine", journal=journal, max_pending=1000)
    report = disp.recover(journal)
    rebuilt_s = time.perf_counter() - t0
    with disp:
        got = {rid: f.result(timeout=600) for rid, f in report["futures"].items()}
        recover_s = time.perf_counter() - t0
        registry = obs.MetricsRegistry()
        obs.register_dispatch(registry, disp)
        obs.register_cache(registry, disp.engine("phi4-mini").schedule_cache)
        obs.register_worker_plane(registry, workers["plane"])
        obs.register_tracer(registry, tracer)
        prom = registry.to_prometheus()
    tracer.disable()
    launches = flash.launches               # ... and ends here
    journal.close()
    say(f"recovered lanes {report['lanes']}: {report['requeued']} requests requeued "
        f"({report['interrupted']} interrupted mid-step, {report['preempted']} un-granted); "
        f"lane rebuilt from its spec and sealed in {rebuilt_s:.2f}s, all replayed in "
        f"{recover_s:.2f}s")
    if report["lanes"] != ["phi4-mini"] or report["requeued"] < 1:
        fail("recovery found no lane or no unfinished request")
    for rid, r in got.items():
        w = want_by_prompt[tuple(int(t) for t in r.prompt)]
        if list(r.generated) != w:
            fail(f"recovered request {rid}: {list(r.generated)} differ from {w}")
    say(f"{len(got)} recovered requests token-identical to the in-process engine's")
    trace = obs.to_chrome_trace(tracer.drain())
    errors = obs.validate_trace(trace)
    say(f"trace of the recovered run: {len(trace['traceEvents'])} events, validate_trace "
        f"{errors}")
    if errors:
        fail(f"the recovered run's trace does not validate: {errors[:5]}")
    families = ("repro_dispatcher_", "repro_schedule_cache_", "repro_workers_", "repro_tracer_")
    missing = [f for f in families if f not in prom]
    say(f"Prometheus exposition: {len(prom.splitlines())} lines; families "
        f"{', '.join(f.rstrip('_') for f in families)} "
        + ("present" if not missing else f"MISSING {missing}"))
    if missing:
        fail(f"the metrics registry lacks {missing}")
    if not launches:
        fail("the recovered lane's seal never launched the flash kernel")
    return {"launches": launches, "recover_s": recover_s}


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("PyTorch is not installed")
    name, count = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail(f"repro_torch not found under {ROOT / 'src'}: run from a checkout of the repo")
    phase_build()
    record = phase_kernel()
    launches, in_replays = phase_serve()
    phase_cpu_parity()
    pack_record = phase_stream_pack()
    pack_launches, pack_in_replays, pack_profiled = phase_nimble()
    arctic = phase_serve_moe("arctic-480b", 8)
    deepseek = phase_serve_moe("deepseek-v2-236b", 9)
    phase_moe_cpu_parity(10)
    seen: set = set()
    with b1_calls(seen):
        vlm = phase_vlm(11)
        audio = phase_audio(12)
        hybrid = phase_recurrent("zamba2-2.7b", 13)
        phase_recurrent("xlstm-125m", 14)
    check_family_launches(seen)
    phase_families_cpu_parity(15)
    dispatch = phase_dispatch(16)
    workers = phase_workers(17)
    journal = phase_journal(18, workers)
    # launches: the wrappers' counts over the paths' runs (each path's
    # counts set to 0 just before it), by path under launches_by_path;
    # launches_in_replays: the kernels the profiler saw in the paths'
    # profiled CUDA-graph replays (profiled_replays of them), which bypass
    # the wrappers
    flash_by_path = {"serve phi4-mini-3.8b": launches, "serve arctic-480b": arctic["flash_launches"],
                     "serve llava-next-34b": vlm["served_launches"],
                     "llava-next-34b forward": vlm["forward_launches"],
                     "seamless-m4t-medium encode, forward, decode": audio["launches"],
                     "zamba2-2.7b forward, decode": hybrid["launches"],
                     "dispatch phi4-mini + deepseek-v2 + smoke lane": dispatch["flash_launches"],
                     "worker plane phi4-mini (in the worker)":
                         workers["launches"].get("flash_attention", 0),
                     "journal recovery phi4-mini": journal["launches"]}
    pack_by_path = {"nimble branchy cells": pack_launches,
                    "serve arctic-480b": arctic["b2_launches"],
                    "serve deepseek-v2-236b": deepseek["b2_launches"],
                    "dispatch phi4-mini + deepseek-v2 + smoke lane": dispatch["b2_launches"]}
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        launches=sum(flash_by_path.values()), launches_by_path=flash_by_path,
        launches_in_replays=(in_replays or 0) + arctic["flash_in_replays"]
        + vlm["flash_in_replays"] + audio["decode"]["flash_in_replay"],
        profiled_replays=(0 if in_replays is None else 1) + 1 + vlm["profiled_replays"] + 1,
        dispatched_in_replays=dispatch["flash_in_replays"],
        **record,
    ), dict(
        name="stream_pack_matmul", route="cuda",
        source="src/repro_torch/kernels/stream_pack/csrc/stream_pack.cu",
        replaces="src/repro/kernels/stream_pack/kernel.py:46",
        launches=sum(pack_by_path.values()), launches_by_path=pack_by_path,
        launches_in_replays=pack_in_replays + arctic["b2_in_replays"] + deepseek["b2_in_replays"],
        profiled_replays=pack_profiled + arctic["profiled_replays"] + deepseek["profiled_replays"],
        dispatched_in_replays=dispatch["b2_in_replays"],
        **pack_record,
    )]
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(f"nvidia-smi: {nvidia_smi()}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
