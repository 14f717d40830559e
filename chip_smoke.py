#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. device: name, count, power limit; TF32 off for float32 matmuls and
   convolutions;
2. build: compile the flash-attention kernel for sm_90a with nvcc, print
   the ptxas register / shared-memory / spill report;
3. kernel against its plain PyTorch version on the card over a sweep of
   dtypes, head dims, GQA groups, lengths (ragged ones included), windows,
   soft-caps (with scores large enough for the cap to matter) and masks,
   each within atol + rtol*|ref|; then times at phi4-mini prefill shapes beside the
   plain version, ``F.scaled_dot_product_attention`` (a yardstick only: the
   port never calls it) and the card's bound;
4. serve: phi4-mini-3.8b at full width and depth, bf16, random weights made
   on the card from a seed, 8 requests through ``ServingEngine`` with
   CUDA-graph-sealed steps; checks the tokens and that prefill went
   through the kernel (the wrapper's count, and the profiler's count of
   flash kernels inside one prefill replay);
5. the same code on the card and on the CPU (2 layers, float32, one set of
   weights): prefill logits within 1e-3 and identical greedy tokens.

The line before the last is the per-kernel JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def tol_ratio(got, ref, dname: str) -> float:
    """Largest ``|got - ref| / (atol + rtol * |ref|)``: within tolerance at <= 1."""
    atol, rtol = TOL[dname]
    ref = ref.float()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


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
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel

    say("== phase 2: build")
    t0 = time.perf_counter()
    build.load(kernel.SOURCE)
    say(f"built {build.library_path(kernel.SOURCE).name} in {time.perf_counter() - t0:.1f}s")
    for line in build.build_log(kernel.SOURCE).splitlines():
        if "ptxas" in line or "spill" in line:
            say(f"  {line.strip()}")


def _qkv(BH_kv, group, Sq, Skv, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((BH_kv * group, Sq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    say("== phase 3: flash_attention kernel vs plain version (tolerance "
        "|err| <= atol + rtol*|ref|: f32 1e-4 + 0 for summation order; bf16 "
        f"1e-2 + 1e-2*|ref| for bf16 rounding of p and output; soft-cap cases "
        f"scale q by {CAP_Q_SCALE:g} so the cap bends the scores)")
    # (group, window, softcap, causal) combinations, run at every dtype,
    # head dim and length
    combos = [(1, 0, 0.0, True), (3, 0, 50.0, True), (4, 16, 0.0, True),
              (3, 100, 50.0, True), (1, 0, 0.0, False), (4, 16, 50.0, False),
              (3, 100, 0.0, False)]
    cases = []
    for dname in ("float32", "bfloat16"):
        for hd in (32, 64, 128):
            for S in (64, 200, 1024):
                for group, window, cap, causal in combos:
                    cases.append((dname, hd, group, S, S, window, cap, causal))
        for causal in (True, False):                 # Sq != Skv
            cases.append((dname, 128, 3, 64, 256, 0, 0.0, causal))
    worst = 0.0
    for i, (dname, hd, group, Sq, Skv, window, cap, causal) in enumerate(cases):
        q, k, v = _qkv(2, group, Sq, Skv, hd, getattr(torch, dname), seed=i)
        if cap:
            q = q * CAP_Q_SCALE                      # a power of 2: exact in bf16
        kw = dict(group=group, softcap=cap, causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tol_ratio(got, ref, dname)
        ok = math.isfinite(err) and ratio <= 1.0
        note = ""
        if cap:
            # the cap must matter here, or this case cannot catch a kernel
            # that ignores it
            uncapped = flash_attention_ref(q, k, v, **{**kw, "softcap": 0.0})
            moved = (uncapped.float() - ref.float()).abs().max().item()
            note = f" | cap moves the output by {moved:.3e}"
            if not moved >= 10 * TOL[dname][0]:
                fail(f"soft-cap {cap} moves the output by only {moved}: the case is blind to it")
        say(f"  {dname:8s} hd={hd:3d} group={group} Sq={Sq:4d} Skv={Skv:4d} "
            f"window={window:3d} softcap={cap:4.0f} causal={int(causal)}: "
            f"max_abs_err {err:.3e} ({ratio:.2f} of tolerance) "
            f"{'ok' if ok else 'FAIL'}{note}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {ratio:.3f} of tolerance {TOL[dname]}")
        worst = max(worst, ratio)
    say(f"  {len(cases)} cases within tolerance (worst at {worst:.2f} of its tolerance)")

    say("-- timing at phi4-mini prefill shapes: q (24,S,128), kv (8,S,128), bf16, causal")
    record = {}
    for S in (512, 2048):
        q, k, v = _qkv(8, 3, S, S, 128, torch.bfloat16, seed=100 + S)
        kw = dict(group=3, causal=True)
        got, ref = flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        if not tol_ratio(got, ref, "bfloat16") <= 1.0:
            fail(f"kernel disagrees at S={S}: max_abs_err {err}")
        iters = 50 if S == 512 else 20
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, **kw), iters)
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), max(5, iters // 5))
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), iters)
        flops = 4 * S * S * 128 * 24 / 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        say(f"  S={S}: kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}) "
            f"max_abs_err {err:.3e} | kernel at {bound_ms / kernel_ms:.1%} of bound")
        if S == 512:     # the largest prefill bucket of phase 4
            record = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return record


def phase_serve() -> tuple[int, int | None]:
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    say("== phase 4: serve phi4-mini-3.8b, full width and depth, bf16, on the card")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    t0 = time.perf_counter()
    params = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"weights: {n_params / 1e9:.3f} B parameters, initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()

    kernel.launches = 0                      # the main path's run starts here
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, max_slots=4, max_len=1024,
                           bucketing="pow2:64:512", device="cuda")
    seal_s = time.perf_counter() - t0
    reqs = serve.make_requests(cfg, 8, max_new=16, seed=0, min_len=20, max_len=501)
    res = serve.serve(engine, reqs)
    torch.cuda.synchronize()
    launches = kernel.launches               # ... and ends here
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
        f"{st.decode_replays} decode replays | flash wrapper calls {launches} "
        f"(eager warm-up runs, plus graph captures that record the kernel "
        f"without running it)")

    if len(res["done"]) != len(reqs):
        fail(f"{len(res['done'])} of {len(reqs)} requests finished")
    for r in res["done"]:
        if r.error or not (len(r.generated) == 16 or r.truncated):
            fail(f"request {r.rid}: {len(r.generated)} tokens, error {r.error}")
        toks = np.asarray(r.generated)
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"request {r.rid}: token outside [0, {cfg.vocab})")
    if launches < cfg.n_layers * st.prefill_compiles or st.prefill_compiles < 1:
        fail(f"flash kernel launched {launches} times for {st.prefill_compiles} "
             f"captured prefill buckets: not on the main path")
    if st.prefill_replays != len(reqs) or st.decode_replays != st.steps:
        fail(f"graph replays: prefill {st.prefill_replays}, decode "
             f"{st.decode_replays} over {st.steps} steps")
    per_replay = step_breakdown(engine)
    in_replays = None if per_replay is None else st.prefill_replays * per_replay
    say(f"flash kernels run inside the {st.prefill_replays} prefill replays: "
        f"{'not measured' if in_replays is None else in_replays}")
    return launches, in_replays


def device_kernels(fn) -> list[tuple[float, int, str]]:
    """(device µs, count, name) of each kernel one call of ``fn`` runs, by
    torch.profiler, after one unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
             e.count, e.key) for e in prof.key_averages()]
    return [r for r in rows if r[0] > 0]


def step_breakdown(engine) -> int | None:
    """Where a served step's time goes: graph-replay times of the decode
    step and of each prefill bucket (CUDA events), then the device time
    of one eager decode step and one eager bucket-512 prefill by kernel
    (torch.profiler).  Returns the flash kernels the profiler saw run
    inside one prefill graph replay (None if it saw no device time there).
    Runs on the drained engine; only its idle cache is overwritten."""
    import torch

    params, cache = engine.params, engine.kv_cache
    toks = torch.zeros((engine.max_slots, 1), dtype=torch.long)
    decode_ms = time_ms(lambda: engine._decode(params, cache, toks), 20)
    parts = [f"decode step {decode_ms:.3f}"]
    for b in engine.prompt_buckets:
        exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
        parts.append(f"prefill {b} {time_ms(lambda: exe(params, cache, padded, 0, b), 5):.3f}")
    say(f"graph replay ms: {' | '.join(parts)}")

    # replays do not pass through the wrapper's counter: count the flash
    # kernels that one replay runs on the card
    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    rows = device_kernels(lambda: exe(params, cache, padded, 0, b))
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
        rows = device_kernels(fn)
        total = sum(r[0] for r in rows)
        if total <= 0:
            say(f"eager {name}: the profiler saw no device time")
            continue
        say(f"eager {name}: {total / 1e3:.3f} ms of device time; top kernels:")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    return per_replay


def phase_cpu_parity() -> None:
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models import DenseTransformer, prefill
    from repro_torch.serving import ServingEngine

    say("== phase 5: card against CPU, phi4-mini full width, 2 layers, float32 "
        "(logits within 1e-3: float32 summation order differs across devices)")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), n_layers=2, dtype="float32")
    p_gpu = serve.init_params(cfg, seed=1, device="cuda")
    p_cpu = DenseTransformer(cfg, device="cpu")
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
    # launches: the wrapper's count over the main path's run; launches_in_replays:
    # the kernels its CUDA-graph replays ran, which bypass the wrapper
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        launches=launches, launches_in_replays=in_replays, **record,
    )]
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(f"nvidia-smi: {nvidia_smi()}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
