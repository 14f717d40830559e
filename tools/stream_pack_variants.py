#!/usr/bin/env python3
"""Check and time B2 (stream_pack) at the MoE expert shapes on one card.

    python3 tools/stream_pack_variants.py [--check] [--sweep] [--backward]
        [--train] [--faults] [--clocks] [--wgmma-variants [NAME,...]] [--clusters 1,2,3]
        [--stages 3,4,5] [--edit 'NAME:OLD=>NEW' ...] [--no-served] [--out PATH]

Always: builds the library from ``src/repro_torch/kernels/stream_pack/csrc/
stream_pack.cu`` and prints ptxas's registers and spills of each kernel;
then, unless ``--no-served``, times each expert GEMM of
``chip_smoke.EXPERT_GEMMS`` at the M of
``chip_smoke.EXPERT_TIMED_M`` in a CUDA graph (``chip_smoke.graph_ms``): the
launch ``choose_launch`` makes (the TMA weight stream), the 32-column ring
(``bf16_ring/vec``) and one ``torch.bmm`` (a yardstick), each beside the
bytes bound.

``--check`` first holds every case of ``chip_smoke.pack_cases()`` against the
plain version, printing each case outside ``chip_smoke.PACK_TOL`` (all of
them, not only the first) and the cases that reached each kernel, and runs
each expert GEMM at M 64 twice, which must give the same bits.
``--sweep`` times the ring against the stream over per-lane panels K = N of
256 to 2048 at M 4 and 64 (64 lanes): the measurement ``TMA_MIN_PANEL``
comes from.  ``--backward`` times B2's backward at DeepSeek's full expert
shape (160 lanes, M 64, K 5120, N 1536): its two products reading w^T and
x^T where they lie, the same two products on contiguous copies (the
design before the stream), and two ``torch.bmm``.

``--train`` times DeepSeek-V2's expert products (160 lanes, 5120 x 1536
and 1536 x 5120) in all three layouts, the forward x · w (nn), dx = dy · wᵀ
(nt) and dw = xᵀ · dy (tn), at capacities M of ``TRAIN_M`` (dw's depth):
the 32-column ring, the TMA stream (64-row tiles past M 64), the wgmma
kernel and one ``torch.bmm``, each beside the bound: the measurement
``WGMMA_MIN_DEPTH`` comes from.  ``--faults`` builds each planted fault of
``FAULTS`` into a copy of the source and holds phase 6's wgmma cases (its
ragged shapes and deepseek-v2's six products at M 384) against the plain
version on it: each fault must put some case outside ``PACK_TOL``.

``--clocks`` replays the six products at M 384 and ``torch.bmm`` over the
same views in a CUDA graph for a few seconds each while ``nvidia-smi``
samples the SM clock and the power draw (at the power limit a lower clock
means busier units), and names the kernel ``torch.bmm`` runs.

``--wgmma-variants`` times DeepSeek-V2's six products at M 384 on the
library as it is, its ring forced to each of ``--stages`` and its clusters
to each of ``--clusters`` (with how many the card holds at once), then on
a copy of the source for each named variant of ``WGMMA_VARIANTS`` (all
without names): the products removed (the loads and stores alone), the
loads removed (the products and stores alone).

``--stages`` times the expert GEMMs (and ``--backward``'s two products)
again with the stream's ring forced to each depth.  Each ``--edit`` builds a copy of the source, under ``build/``,
in which the text OLD (it must occur exactly once; several edits of one
NAME apply in turn) is replaced by NEW: a variant for a measurement (the
products removed, to time the loads alone) or a planted fault; the expert
GEMMs (and ``--backward``) are timed again on each copy.

The results also go to ``--out`` as JSON (default
``build/stream_pack_variants.json``).  Numbers
from this script are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


# the capacities --train times: the served path's largest, then training's
# up to DeepSeek-V2's 384
TRAIN_M = (64, 96, 128, 160, 256, 384)
# planted faults in the wgmma kernel: NAME -> "OLD=>NEW" edits of the source
FAULTS = {
    # every item's last 64-deep chunk is neither loaded nor multiplied
    "last_chunk_dropped": ["(p.D + WG_KC - 1) / WG_KC;=>max(1, (p.D - 1) / WG_KC);"],
    # nt's wᵀ, which lies K-major (wgmma's native B), read as MN-major
    "nt_b_as_mn_major": ["wgmma_n256<AT ? 1 : 0, BT ? 0 : 1>=>wgmma_n256<AT ? 1 : 0, 1>"],
}


# the wgmma kernel with a part taken out, for --wgmma-variants: NAME -> edits
# ("OLD=>NEW", or (START, END, NEW): the text from START up to END replaced)
WGMMA_VARIANTS = {
    # the products removed: the loads and the stores alone
    "loads_only": ["wgmma_n256<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db, c > 0 || kk > 0);=>"
                   "asm volatile(\"\" ::\"l\"(da), \"l\"(db));"],
    # the loads removed (each stage's barrier completed by thread 0 at once):
    # the products and the stores alone
    "products_only": [("          mbar_expect_tx(full(s), bytes);\n"
                       "          const uint32_t a = ring + s * WG_STAGE",
                       "\n        }\n      }\n    }\n    __syncwarp();",
                       "          mbar_arrive(full(s));")],
}


def edited(name: str, edits: list, source: Path, into: Path) -> Path:
    """A copy of ``source`` with each edit made once ("OLD=>NEW", or (START,
    END, NEW): the text from START up to END replaced), beside a copy of the
    shared header at the relative path the source includes."""
    text = source.read_text()
    for edit in edits:
        if isinstance(edit, tuple):
            start, end, new = edit
            if text.count(start) != 1:
                raise SystemExit(f"{name}: the text {start!r} occurs {text.count(start)} times")
            i = text.index(start)
            j = text.index(end, i)
            text = text[:i] + new + text[j:]
            continue
        old, new = edit.split("=>", 1)
        if text.count(old) != 1:
            raise SystemExit(f"--edit {name}: the text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    copy = into / name / "stream_pack" / "csrc" / f"stream_pack_{name}.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    header = source.parents[2] / "flash_attention" / "csrc" / "hopper.cuh"
    shared = into / name / "flash_attention" / "csrc" / "hopper.cuh"
    shared.parent.mkdir(parents=True, exist_ok=True)
    shared.write_text(header.read_text())
    return copy


def forced(pack, kind: str, lanes: int, M: int, N: int, K: int, **layout):
    """The launch of ``kind``: "ring" (the stream's panel threshold out of
    reach) or "stream" (its threshold at 0)."""
    keep = pack.TMA_MIN_PANEL
    try:
        pack.TMA_MIN_PANEL = 1 << 62 if kind == "ring" else 0
        return pack.choose_launch(lanes, M, N, K, "bfloat16", True, **layout)
    finally:
        pack.TMA_MIN_PANEL = keep


def run_with(pack, launch, x, w):
    """The wrapper's launch for (x, w) with ``launch`` in place of the
    chooser's (None: the chooser's own)."""
    blocks = dict(block_m=x.shape[1], block_n=w.shape[2], block_k=x.shape[2])
    if launch is None:
        return pack.stream_pack_matmul(x, w, **blocks)
    keep, pack.launch_for = pack.launch_for, lambda *_: launch
    try:
        return pack.stream_pack_matmul(x, w, **blocks)
    finally:
        pack.launch_for = keep


def check(smoke, pack, torch) -> int:
    from repro_torch.kernels.stream_pack import (stream_pack, stream_pack_matmul,
                                                 stream_pack_matmul_ref)

    bad, reached, made = 0, {}, []
    for n, (dname, lanes, (M, K, N), shared, offset, layout) in enumerate(smoke.pack_cases()):
        x, w = smoke._pack_inputs(lanes, M, K, N, getattr(torch, dname), shared, seed=n,
                                  offset=offset, layout=layout)
        ln = pack.launch_for(x, w)
        got = stream_pack_matmul(x, w, block_m=M, block_n=N, block_k=K)
        ref = stream_pack_matmul_ref(x, w)
        torch.cuda.synchronize()
        r = smoke.ratio(got, ref, *smoke.PACK_TOL[dname])
        if not r <= 1.0:
            bad += 1
            print(f"  OUT: {dname} lanes {lanes} M {M} K {K} N {N} shared {shared} offset "
                  f"{offset} layout {layout} ({smoke._tile(ln)}): {r:.3f} of tolerance")
        reached[ln.instance] = reached.get(ln.instance, 0) + 1
        made.append(ln)
    print(f"check: {bad} cases outside tolerance; by kernel: {sorted(reached.items())}; "
          f"missing {sorted(smoke.pack_coverage(made))}", flush=True)
    for arch, (lanes, D, F) in smoke.EXPERT_GEMMS.items():
        for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
            g = torch.Generator(device="cuda").manual_seed(7)
            x = torch.randn((lanes, 64, K), generator=g, device="cuda", dtype=torch.bfloat16)
            w = torch.randn((lanes, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            a, b = stream_pack(x, w), stream_pack(x, w)
            same = torch.equal(a.view(torch.int16), b.view(torch.int16))
            worst = max(smoke.ratio(a[i:i + 16], stream_pack_matmul_ref(x[i:i + 16], w[i:i + 16]),
                                    *smoke.PACK_TOL["bfloat16"]) for i in range(0, lanes, 16))
            print(f"  {arch} {gemm} M 64: two runs bit-identical {same}; {worst:.3f} of "
                  f"tolerance", flush=True)
            bad += (not same) + (not worst <= 1.0)
            del x, w, a, b
    return bad


def expert_times(smoke, pack, torch, stages=()) -> list[dict]:
    rows = []
    for arch, (lanes, D, F) in smoke.EXPERT_GEMMS.items():
        for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
            g = torch.Generator(device="cuda").manual_seed(lanes + K)
            w = torch.randn((lanes, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            for M in smoke.EXPERT_TIMED_M:
                x = torch.randn((lanes, M, K), generator=g, device="cuda", dtype=torch.bfloat16)
                nbytes = 2 * lanes * (M * K + K * N + M * N)
                bound_ms, _ = smoke.bound(2.0 * lanes * M * N * K, nbytes, "bfloat16")
                row = dict(model=arch, gemm=gemm, M=M, K=K, N=N, bound_ms=bound_ms,
                           chosen=smoke._tile(pack.launch_for(x, w)))
                for kind in ("chosen", "ring"):
                    ln = None if kind == "chosen" else forced(pack, kind, lanes, M, N, K)
                    row[kind] = smoke.graph_ms(
                        lambda ln=ln: run_with(pack, ln, x, w), reps=5, iters=10)
                for depth in stages:
                    ln = pack.launch_for(x, w)
                    if pack.tma_smem_bytes(ln.bm, depth) > 232448:   # the card's most
                        continue
                    ln = dataclasses.replace(ln, stages=depth,
                                             smem_bytes=pack.tma_smem_bytes(ln.bm, depth))
                    row[f"stages {depth}"] = smoke.graph_ms(
                        lambda ln=ln: run_with(pack, ln, x, w), reps=5, iters=10)
                row["bmm"] = smoke.graph_ms(lambda: torch.bmm(x, w), reps=5, iters=10)
                print(f"  {arch} {gemm} M {M}: " + " | ".join(
                    f"{k} {v:.5f}" for k, v in row.items() if isinstance(v, float))
                    + f" ms | chosen {row['chosen']} at {bound_ms / row['chosen']:.1%} of "
                    f"bound", flush=True)
                rows.append(row)
                del x
            del w
            torch.cuda.empty_cache()
    return rows


def sweep(smoke, pack, torch) -> list[dict]:
    rows, lanes = [], 64
    for S in (256, 512, 768, 1024, 1536, 2048):
        g = torch.Generator(device="cuda").manual_seed(S)
        w = torch.randn((lanes, S, S), generator=g, device="cuda", dtype=torch.bfloat16)
        for M in (4, 64):
            x = torch.randn((lanes, M, S), generator=g, device="cuda", dtype=torch.bfloat16)
            row = dict(panel_bytes=2 * S * S, M=M)
            for kind in ("ring", "stream"):
                ln = forced(pack, kind, lanes, M, S, S)
                row[kind] = smoke.graph_ms(
                    lambda ln=ln: run_with(pack, ln, x, w), reps=10, iters=20)
            row["bound_ms"] = smoke.bound(2.0 * lanes * M * S * S,
                                          2 * lanes * (M * S + S * S + M * S), "bfloat16")[0]
            print(f"  panel {S}x{S} M {M}: " + " | ".join(
                f"{k} {v:.5f}" for k, v in row.items() if isinstance(v, float)), flush=True)
            rows.append(row)
    return rows


def train_sweep(smoke, pack, torch) -> list[dict]:
    """The ring, the stream, the wgmma kernel and torch.bmm at DeepSeek-V2's
    expert products over ``TRAIN_M``, in a CUDA graph."""
    rows = []
    lanes, D, F = smoke.EXPERT_GEMMS["deepseek-v2-236b"]
    for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
        for M in TRAIN_M:
            products = smoke.train_products(lanes, M, K, N, seed=M + K)
            for product, (layout, a, b) in products.items():
                (_, R, Dp), C = a.shape, b.shape[2]
                x_t, w_t = layout[0] == "t", layout[1] == "t"
                launches = {
                    "ring": forced(pack, "ring", lanes, R, C, Dp, x_t=x_t, w_t=w_t),
                    "stream": pack._tma_launch(lanes, R, C, 64 if x_t or R > 64 else
                                               pack._fit(R, pack.TMA_ROWS), layout),
                    "wgmma": pack._wgmma_launch(lanes, R, C, layout)}
                bound_ms, _ = smoke.bound(2.0 * lanes * R * C * Dp,
                                          2 * lanes * (R * Dp + Dp * C + R * C), "bfloat16")
                row = dict(gemm=gemm, product=product, layout=layout, M=M, bound_ms=bound_ms,
                           chosen=pack.launch_for(a, b).variant)
                for kind, ln in launches.items():
                    slow = kind == "ring" and layout != "nn"     # element-wise loads
                    row[kind] = smoke.graph_ms(lambda ln=ln: run_with(pack, ln, a, b),
                                               reps=2 if slow else 5, iters=3 if slow else 10)
                row["bmm"] = smoke.graph_ms(lambda: torch.bmm(a, b), reps=5, iters=10)
                print(f"  {gemm} {product} ({layout}) M {M}: " + " | ".join(
                    f"{k} {v:.5f}" for k, v in row.items() if isinstance(v, float) and k != "M")
                    + f" ms | chooser: {row['chosen']}; wgmma at {bound_ms / row['wgmma']:.1%} "
                    f"of bound, {row['bmm'] / row['wgmma']:.3f}x torch.bmm's speed", flush=True)
                rows.append(row)
            del products, a, b
            torch.cuda.empty_cache()
    return rows


def train_times(smoke, pack, torch, stages=(), clusters=()) -> list[dict]:
    """DeepSeek-V2's six expert products at M ``TRAIN_EXPERT_M`` in a CUDA
    graph: the chooser's launch (and its ring forced to each of ``stages``,
    its clusters to each of ``clusters`` that divides the row tiles) beside
    the bound."""
    rows = []
    lanes, D, F = smoke.EXPERT_GEMMS["deepseek-v2-236b"]
    M = smoke.TRAIN_EXPERT_M
    for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
        products = smoke.train_products(lanes, M, K, N, seed=M + K)
        for product, (layout, a, b) in products.items():
            (_, R, Dp), C = a.shape, b.shape[2]
            bound_ms, _ = smoke.bound(2.0 * lanes * R * C * Dp,
                                      2 * lanes * (R * Dp + Dp * C + R * C), "bfloat16")
            ln = pack.launch_for(a, b)
            row = dict(gemm=gemm, product=product, layout=layout, chosen=smoke._tile(ln),
                       bound_ms=bound_ms)
            try:        # a variant's ring may not fit at the chooser's depth
                row["ms"] = smoke.graph_ms(lambda: run_with(pack, None, a, b), reps=5,
                                           iters=10)
            except RuntimeError as err:
                print(f"  {gemm} {product}: {err}", flush=True)
                row["ms"] = math.nan
            for depth in stages:
                if pack.wgmma_smem_bytes(depth) > 232448:   # the card's most
                    continue
                forced_ln = dataclasses.replace(ln, stages=depth,
                                                smem_bytes=pack.wgmma_smem_bytes(depth))
                row[f"stages {depth}"] = smoke.graph_ms(
                    lambda fl=forced_ln: run_with(pack, fl, a, b), reps=5, iters=10)
            for cl in clusters:
                if -(-R // pack.WGMMA_BM) % cl:
                    continue
                forced_ln = dataclasses.replace(ln, cluster=cl,
                                                grid=(pack.SMS // cl * cl, 1, 1))
                row[f"resident clusters of {cl}"] = pack.resident_clusters(forced_ln, a.device)
                row[f"cluster {cl}"] = smoke.graph_ms(
                    lambda fl=forced_ln: run_with(pack, fl, a, b), reps=5, iters=10)
            print(f"  {gemm} {product} ({layout}): " + " | ".join(
                f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items() if isinstance(v, (int, float)))
                + f" ms | {row['chosen']} at {bound_ms / row['ms']:.1%} of bound", flush=True)
            rows.append(row)
        del products, a, b
        torch.cuda.empty_cache()
    return rows


def clocks(smoke, pack, torch, seconds: float = 3.0) -> list[dict]:
    """DeepSeek-V2's six products at M 384, the chooser's launch and one
    ``torch.bmm``, each replayed in a CUDA graph for ``seconds`` while
    ``nvidia-smi`` samples the card's SM clock and power draw: at the power
    limit, a lower clock under the same draw means busier units.  Also the
    name of the kernel ``torch.bmm`` runs."""
    import statistics
    import subprocess
    import threading
    import time

    from repro_torch.core.capture import capture_graph

    def sample(stop, out):
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            try:
                out.append(tuple(float(v) for v in r.stdout.strip().split(",")))
            except ValueError:
                pass
            time.sleep(0.05)

    def run(fn):
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with capture_graph(graph, capture_error_mode="global"):
            for _ in range(10):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        stop, out = threading.Event(), []
        sampler = threading.Thread(target=sample, args=(stop, out))
        sampler.start()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0, calls = time.time(), 0
        start.record()
        while time.time() - t0 < seconds:
            graph.replay()
            calls += 10
            if calls % 200 == 0:
                torch.cuda.synchronize()
        end.record()
        end.synchronize()
        stop.set()
        sampler.join()
        out = out[len(out) // 4:]        # past the clock's first ramp
        return (start.elapsed_time(end) / calls, statistics.median(o[0] for o in out),
                statistics.median(o[1] for o in out))

    rows = []
    lanes, D, F = smoke.EXPERT_GEMMS["deepseek-v2-236b"]
    M = smoke.TRAIN_EXPERT_M
    for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
        products = smoke.train_products(lanes, M, K, N, seed=M + K)
        for product, (layout, a, b) in products.items():
            row = dict(gemm=gemm, product=product, layout=layout)
            for name, fn in (("kernel", lambda: run_with(pack, None, a, b)),
                             ("bmm", lambda: torch.bmm(a, b))):
                row[name] = dict(zip(("ms", "sm_mhz", "watts"), run(fn)))
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.bmm(a, b)
                torch.cuda.synchronize()
            row["bmm_kernels"] = sorted({e.key for e in prof.key_averages()
                                         if any(w in e.key.lower() for w in smoke.GEMM_NAMES)})
            print(f"  {gemm} {product} ({layout}): " + " | ".join(
                f"{k} {v['ms']:.5f} ms at {v['sm_mhz']:.0f} MHz, {v['watts']:.1f} W"
                for k, v in row.items() if isinstance(v, dict)) + f" | bmm runs {row['bmm_kernels']}",
                flush=True)
            rows.append(row)
        del products, a, b
        torch.cuda.empty_cache()
    return rows


def wgmma_check(smoke, pack, torch) -> int:
    """Phase 6's wgmma cases against the plain version: its ragged shapes
    and deepseek-v2's six products at M 384 (``REF_LANES`` lanes at a
    time); returns the cases outside ``PACK_TOL``, each printed."""
    from repro_torch.kernels.stream_pack import stream_pack, stream_pack_matmul_ref

    bad, n = 0, 0
    cases = [(lanes, M, K, N, layout, None) for lanes, M, K, N, layout in smoke.PACK_WGMMA_SHAPES]
    lanes, D, F = smoke.EXPERT_GEMMS["deepseek-v2-236b"]
    cases += [(lanes, smoke.TRAIN_EXPERT_M, K, N, None, gemm)
              for gemm, K, N in (("gate/up", D, F), ("down", F, D))]
    for lanes, M, K, N, layout, gemm in cases:
        if gemm is None:
            x, w = smoke._pack_inputs(lanes, M, K, N, torch.bfloat16, False, seed=M + K,
                                      layout=layout)
            products = {"case": (layout, x, w)}
        else:
            products = smoke.train_products(lanes, M, K, N, seed=lanes + K + M)
        for product, (lay, a, b) in products.items():
            ln = pack.launch_for(a, b)
            got = stream_pack(a, b)
            worst = max(smoke.ratio(got[i:i + smoke.REF_LANES],
                                    stream_pack_matmul_ref(a[i:i + smoke.REF_LANES],
                                                           b[i:i + smoke.REF_LANES]),
                                    *smoke.PACK_TOL["bfloat16"])
                        for i in range(0, a.shape[0], smoke.REF_LANES))
            n += 1
            if not worst <= 1.0:
                bad += 1
            print(f"  {'OUT' if not worst <= 1.0 else 'in '}: {gemm or ''} {product} {lay} "
                  f"lanes {a.shape[0]} M {a.shape[1]} K {a.shape[2]} N {b.shape[2]} "
                  f"({smoke._tile(ln)}): {worst:.3f} of tolerance", flush=True)
            del got
        del products
        torch.cuda.empty_cache()
    print(f"wgmma check: {bad} of {n} cases outside tolerance", flush=True)
    return bad


def backward(smoke, pack, torch, stages=()) -> dict:
    from repro_torch.kernels.stream_pack.ops import _stream_pack

    lanes, M, K, N = 160, 64, 5120, 1536
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((lanes, M, K), generator=g, device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((lanes, K, N), generator=g, device="cuda") / math.sqrt(K)).to(torch.bfloat16)
    dy = torch.randn((lanes, M, N), generator=g, device="cuda", dtype=torch.bfloat16)
    out = {}
    calls = {
        "views": lambda: (_stream_pack(dy, w.transpose(1, 2)), _stream_pack(x.transpose(1, 2), dy)),
        "dx": lambda: _stream_pack(dy, w.transpose(1, 2)),
        "dw": lambda: _stream_pack(x.transpose(1, 2), dy),
        "copies": lambda: (_stream_pack(dy, w.transpose(1, 2).contiguous()),
                           _stream_pack(x.transpose(1, 2).contiguous(), dy)),
        "bmm": lambda: (torch.bmm(dy, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), dy)),
    }
    for name, fn in calls.items():
        out[name] = smoke.graph_ms(fn, reps=5, iters=10)
    for depth in stages:    # the stream's ring forced to other depths, dx and dw alone
        if pack.tma_smem_bytes(64, depth) > 232448:   # the card's most
            continue
        keep, pack.TMA_STAGES = pack.TMA_STAGES, depth
        try:
            out[f"dx stages {depth}"] = smoke.graph_ms(calls["dx"], reps=5, iters=10)
            out[f"dw stages {depth}"] = smoke.graph_ms(calls["dw"], reps=5, iters=10)
        finally:
            pack.TMA_STAGES = keep
    out["variants"] = [pack.launch_for(dy, w.transpose(1, 2)).variant,
                       pack.launch_for(x.transpose(1, 2), dy).variant,
                       pack.launch_for(dy, w.transpose(1, 2).contiguous()).variant,
                       pack.launch_for(x.transpose(1, 2).contiguous(), dy).variant]
    nbytes = 2 * (2 * x.numel() + 2 * w.numel() + dy.numel())
    out["bound_ms"] = smoke.bound(4.0 * lanes * M * K * N, nbytes, "bfloat16")[0]
    print("  backward (160, 64, 5120, 1536): " + " | ".join(
        f"{k} {v:.5f}" for k, v in out.items() if isinstance(v, float))
        + f" ms; variants {out['variants']}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--wgmma-variants", nargs="?", const=",".join(WGMMA_VARIANTS), default=None,
                    help="the variants of WGMMA_VARIANTS to time, comma-separated (all)")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--clusters", default="",
                    help="cluster sizes to force on the six products, comma-separated")
    ap.add_argument("--no-served", action="store_true",
                    help="skip the served expert GEMMs' times (M 4 and 64)")
    ap.add_argument("--stages", default="", help="ring depths to force, comma-separated")
    ap.add_argument("--edit", action="append", default=[], help="NAME:OLD=>NEW")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "stream_pack_variants.json")
    args = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.stream_pack import kernel as pack

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smoke.nvidia_smi()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    pack._library(torch.device("cuda", 0))
    for line in build.build_log(pack.SOURCE).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smoke.nvidia_smi()}
    if args.check:
        result["check_failures"] = check(smoke, pack, torch)
    stages = [int(d) for d in args.stages.split(",") if d]
    if not args.no_served:
        print("-- expert GEMMs in a CUDA graph, ms", flush=True)
        result["experts"] = expert_times(smoke, pack, torch, stages)
    if args.sweep:
        print("-- panel sweep, 64 lanes, ms", flush=True)
        result["sweep"] = sweep(smoke, pack, torch)
    if args.backward:
        result["backward"] = backward(smoke, pack, torch, stages)
    if args.train:
        print("-- training's products, 160 lanes, in a CUDA graph, ms", flush=True)
        result["train"] = train_sweep(smoke, pack, torch)
    if args.wgmma_variants is not None:
        print("-- training's six products at M 384, the library as it is, ms", flush=True)
        result["wgmma"] = train_times(smoke, pack, torch, stages,
                                      [int(c) for c in args.clusters.split(",") if c])
        for name in filter(None, args.wgmma_variants.split(",")):
            changes = WGMMA_VARIANTS[name]
            print(f"-- variant {name}: the six products, ms", flush=True)
            with library(build, pack, edited(name, changes, pack.SOURCE,
                                             ROOT / "build" / "variants")):
                result[f"wgmma {name}"] = train_times(smoke, pack, torch, stages)
    if args.clocks:
        print("-- training's six products and torch.bmm, the card's clock and power under each",
              flush=True)
        result["clocks"] = clocks(smoke, pack, torch)
    if args.faults:
        print("-- phase 6's wgmma cases on the library as it is", flush=True)
        result["faults"] = {"none": wgmma_check(smoke, pack, torch)}
        for name, changes in FAULTS.items():
            print(f"-- planted fault {name}: {changes}", flush=True)
            with library(build, pack, edited(name, changes, pack.SOURCE,
                                             ROOT / "build" / "faults")):
                result["faults"][name] = wgmma_check(smoke, pack, torch)
        missed = [k for k, v in result["faults"].items() if (v == 0) == (k != "none")]
        print(f"faults: cases outside tolerance {result['faults']}; "
              f"{'every fault caught' if not missed else f'NOT AS EXPECTED: {missed}'}",
              flush=True)
        result["faults_missed"] = missed
    edits: dict[str, list[str]] = {}
    for spec in args.edit:
        name, edit = spec.split(":", 1)
        edits.setdefault(name, []).append(edit)
    for name, changes in edits.items():
        with library(build, pack, edited(name, changes, pack.SOURCE, ROOT / "build" / "variants")):
            print(f"-- variant {name}: expert GEMMs in a CUDA graph, ms", flush=True)
            result[f"experts {name}"] = expert_times(smoke, pack, torch)
            if args.backward:
                result[f"backward {name}"] = backward(smoke, pack, torch)
            if args.train:
                result[f"train {name}"] = train_sweep(smoke, pack, torch)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1, default=str))
    if result.get("check_failures"):
        raise SystemExit(f"{result['check_failures']} checks failed")
    if result.get("faults_missed"):
        raise SystemExit(f"planted faults not as expected: {result['faults_missed']}")


@contextlib.contextmanager
def library(build, pack, source: Path):
    """The wrapper's launches go to the library built from ``source`` (an
    edited copy) while the context is open."""
    lib = build.load(source)
    import chip_smoke

    print(f"  ptxas, {source.name}: {chip_smoke.pack_registers(build.build_log(source))}",
          flush=True)
    for fn in ("stream_pack_init", "stream_pack_matmul", "stream_pack_wgmma_clusters"):
        getattr(lib, fn).argtypes = getattr(pack._lib, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if lib.stream_pack_init() != 0:
        raise SystemExit(f"{source}: stream_pack_init failed")
    keep, pack._lib = pack._lib, lib
    try:
        yield lib
    finally:
        pack._lib = keep


if __name__ == "__main__":
    main()
