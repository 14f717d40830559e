#!/usr/bin/env python3
"""Check and time B2 (stream_pack) at the MoE expert shapes on one card.

    python3 tools/stream_pack_variants.py [--check] [--sweep] [--backward]
        [--stages 3,4,5] [--edit 'NAME:OLD=>NEW' ...] [--out PATH]

Always: builds the library from ``src/repro_torch/kernels/stream_pack/csrc/
stream_pack.cu``, prints ptxas's registers and spills of each kernel, then
times each expert GEMM of ``chip_smoke.EXPERT_GEMMS`` at the M of
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
import ctypes
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def edited(name: str, edits: list[str], source: Path, into: Path) -> Path:
    """A copy of ``source`` with each edit ("OLD=>NEW") made once, beside a
    copy of the shared header at the relative path the source includes."""
    text = source.read_text()
    for edit in edits:
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
    if launch is None:
        return pack.stream_pack_matmul(x, w)
    keep, pack.launch_for = pack.launch_for, lambda *_: launch
    try:
        return pack.stream_pack_matmul(x, w)
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
    print("-- expert GEMMs in a CUDA graph, ms", flush=True)
    result["experts"] = expert_times(smoke, pack, torch, stages)
    if args.sweep:
        print("-- panel sweep, 64 lanes, ms", flush=True)
        result["sweep"] = sweep(smoke, pack, torch)
    if args.backward:
        result["backward"] = backward(smoke, pack, torch, stages)
    edits: dict[str, list[str]] = {}
    for spec in args.edit:
        name, edit = spec.split(":", 1)
        edits.setdefault(name, []).append(edit)
    for name, changes in edits.items():
        lib = build.load(edited(name, changes, pack.SOURCE, ROOT / "build" / "variants"))
        for fn in ("stream_pack_init", "stream_pack_matmul"):
            getattr(lib, fn).argtypes = getattr(pack._lib, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if lib.stream_pack_init() != 0:
            raise SystemExit(f"--edit {name}: stream_pack_init failed")
        keep, pack._lib = pack._lib, lib
        print(f"-- variant {name}: expert GEMMs in a CUDA graph, ms", flush=True)
        result[f"experts {name}"] = expert_times(smoke, pack, torch)
        if args.backward:
            result[f"backward {name}"] = backward(smoke, pack, torch)
        pack._lib = keep
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1, default=str))
    if result.get("check_failures"):
        raise SystemExit(f"{result['check_failures']} checks failed")


if __name__ == "__main__":
    main()
