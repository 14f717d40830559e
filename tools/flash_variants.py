#!/usr/bin/env python3
"""Time copies of B1's CUDA source against each other on one card.

    python3 tools/flash_variants.py [--trace] [--lengths 64,512,2048] A.cu [B.cu ...]

Each argument is a copy of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, edited by hand (another ring depth, another pipeline).
All are built at once (one ``nvcc`` each) and loaded in turn in place of the
library.  For each length S (phi4-mini's prefill attention: q (24,S,128),
kv (8,S,128), bf16, causal) and each bf16 tile of ``kernel.TILES`` forced in
turn, the script prints the time of one call inside a CUDA graph
(``chip_smoke.graph_ms``) and its error against the plain version as a share
of ``chip_smoke.TOL``, then ``F.scaled_dot_product_attention``'s time.

``--trace`` first instruments each copy: the heaviest query tile of head 0
stamps ``%globaltimer`` (ns) when its producer has a free slot for each tile,
and, for each tile of its first consumer warpgroup, when the tile's K and
the previous tile's V are in, when Q K^T is done, when the softmax is done
and when the previous tile's PV is done and P is packed; the stamps of one
launch are printed relative to the CTA's start.  Numbers from this script
are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def instrument(text: str) -> str:
    """The source with the stamps of ``--trace`` (see the module doc)."""
    def after(anchor: str, stamp: str, nth: int = 1) -> None:
        nonlocal text
        at = -1
        for _ in range(nth):
            at = text.index(anchor, at + 1)
        at += len(anchor)
        text = text[:at] + stamp + text[at:]

    consumer = "if (TRACE_ON && threadIdx.x == 0 && j < 30) g_trace[4 + 4 * j + {}] = gtime();\n"
    after("  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;\n",
          "  const bool TRACE_ON = blockIdx.x == 0 && blockIdx.y == 0;\n"
          "  if (TRACE_ON && threadIdx.x == 0) g_trace[0] = gtime();\n")
    after("        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);\n",
          "        if (TRACE_ON && i < 124) g_trace[128 + i] = gtime();\n")
    after("      mbar_wait(v_full(slot(ip)), parity(ip));\n", "      " + consumer.format(0))
    after("      wgmma_wait<1>();", "\n      " + consumer.format(1))
    after("      softmax((t0 + i) * BKV);\n", "      " + consumer.format(2))
    after("      rescale_and_pack();\n", "      " + consumer.format(3), nth=2)
    text = text.replace("namespace {\n", (
        "namespace {\n__device__ long long g_trace[256];\n"
        "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'), 1)
    return text + ('\nextern "C" int flash_trace(long long* out) {\n'
                   "  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(long long) * 256);\n}\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--lengths", default="64,128,256,512,2048")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, kernel

    c.phase_device()
    # each copy is built beside the shared header it includes
    variants = build.BUILD_DIR / "variants"
    variants.mkdir(parents=True, exist_ok=True)
    header = kernel.SOURCE.parent / "hopper.cuh"
    (variants / header.name).write_text(header.read_text())
    sources = []
    for src in args.sources:
        text = src.read_text()
        copy = variants / (f"{src.stem}_trace.cu" if args.trace else src.name)
        copy.write_text(instrument(text) if args.trace else text)
        sources.append(copy)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for src in sources:
        entry = None
        for line in build.build_log(src).splitlines():
            found = re.search(r"(flash_fwd_\w+?)E*v", line) if "Compiling entry" in line else None
            entry = found.group(1) if found else entry
            if ("Used" in line or "warning" in line.lower()
                    or ("spill" in line and " 0 bytes spill stores" not in line)):
                print(f"  {src.stem} {entry}: {line.strip()}", flush=True)

    for S in (int(x) for x in args.lengths.split(",")):
        q, k, v = c._qkv(8, 3, S, S, 128, torch.bfloat16, seed=100 + S)
        ref = flash_attention_ref(q, k, v, group=3)
        for src in sources:
            kernel.SOURCE, kernel._fn = src, None
            for tile in kernel.TILES:
                kernel.choose_tile = lambda *_, t=tile: t
                kernel.choose_launch.cache_clear()
                r = c.tol_ratio(flash_attention(q, k, v, group=3), ref, "bfloat16")
                ms = c.graph_ms(lambda: flash_attention(q, k, v, group=3))
                print(f"S={S} {src.stem} tile {tile}: graph {ms:.5f} ms, {r:.2f} of tolerance",
                      flush=True)
                if args.trace:
                    flash_attention(q, k, v, group=3)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_longlong * 256)()
                    build.load(src).flash_trace(buf)
                    t = [x - buf[0] for x in buf]
                    tiles = -(-S // 64)
                    steps = [t[4 + 4 * j: 8 + 4 * j] for j in range(1, min(tiles, 30))]
                    print(f"   consumer steps (K/V in, QK done, softmax done, PV done + "
                          f"pack), ns: {steps}", flush=True)
                    print(f"   producer slot free, ns: {t[128:128 + min(tiles, 124)]}", flush=True)
        lib = c.graph_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True))
        print(f"S={S} F.scaled_dot_product_attention: graph {lib:.5f} ms", flush=True)


if __name__ == "__main__":
    main()
