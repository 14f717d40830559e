#!/usr/bin/env python3
"""Check and time B3 (decode attention) and edited copies of it on one card.

    python3 tools/decode_variants.py [--check] [--shapes 0,2] [--long] [--clusters 2,4,8]
        [--edit 'NAME:OLD=>NEW' ...]

The library is built from ``src/repro_torch/kernels/decode_attention/csrc/
decode_attention.cu``, and each ``--edit`` from a copy of it, made under
``build/`` where the script runs, in which the text OLD (it must occur
exactly once) is replaced by NEW: a variant for a measurement (the math
removed, to time the loads alone) or a planted fault.  For each of them in
turn, ``--check`` holds every case of ``chip_smoke.DECODE_CASES`` at both
dtypes against the plain version and prints its share of
``chip_smoke.DECODE_TOL`` (a planted fault must show there); then each
shape of ``chip_smoke.DECODE_TIMED`` (or ``--shapes``: indices into
``DECODE_CASES``) is timed in a CUDA graph (``chip_smoke.graph_ms``) with
its plan, and again with the plan's cluster forced to each size of
``--clusters``, each with its error's share of the tolerance; ``--long``
times long_500k's shapes instead (``chip_smoke.LONG_SHAPES``: a cache of
524288 positions, kv_valid near its end).  Numbers from
this script are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def edited(name: str, edit: str, source: Path, header: Path, into: Path) -> Path:
    """A copy of ``source`` with ``edit`` ("OLD=>NEW") made once, beside a
    copy of the shared header at the relative path the source includes."""
    old, new = edit.split("=>", 1)
    text = source.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"--edit {name}: the text {old!r} occurs {text.count(old)} times")
    copy = into / name / "decode_attention" / "csrc" / f"decode_attention_{name}.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text.replace(old, new))
    shared = into / name / "flash_attention" / "csrc" / header.name
    shared.parent.mkdir(parents=True, exist_ok=True)
    shared.write_text(header.read_text())
    return copy


def with_cluster(launch, n: int):
    """``launch`` with its span split over ``n`` ranks (fewer when ``n``
    would leave a rank without a tile)."""
    from repro_torch.kernels.decode_attention import kernel

    tiles = -(-launch.span // kernel.TILE)
    per = -(-tiles // n)
    c = -(-tiles // per)
    return dataclasses.replace(launch, cluster=c, chunk=kernel.TILE * per,
                               grid=(c,) + launch.grid[1:],
                               new_rank=None if launch.new_rank is None else c - 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--edit", action="append", default=[], metavar="NAME:OLD=>NEW")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--clusters", default="")
    ap.add_argument("--long", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention import kernel

    c.phase_device()
    header = kernel.SOURCE.parents[2] / "flash_attention" / "csrc" / "hopper.cuh"
    sources = [("library", kernel.SOURCE)]
    for spec in args.edit:
        name, edit = spec.split(":", 1)
        sources.append((name, edited(name, edit, kernel.SOURCE, header,
                                     build.BUILD_DIR / "variants")))
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, [src for _, src in sources]))
    shapes = ([int(i) for i in args.shapes.split(",")] if args.shapes else list(c.DECODE_TIMED))
    clusters = [int(n) for n in args.clusters.split(",") if n]
    plan_of = kernel.launch_for
    for name, src in sources:
        kernel.SOURCE, kernel._lib = src, None
        kernel._ready_devices.clear()
        if args.check:
            for i, (label, arch, smoke, B, T, S, new, kvv0d) in enumerate(c.DECODE_CASES):
                for dname in ("float32", "bfloat16"):
                    q, kc, vc, kn, vn, kw = c._decode_inputs(arch, smoke, B, T, S, new, kvv0d,
                                                             getattr(torch, dname), seed=300 + i)
                    r = c.decode_ratio(decode_attention(q, kc, vc, kn, vn, **kw),
                                       decode_attention_ref(q, kc, vc, kn, vn, **kw), dname)
                    print(f"{name} check {dname:8s} {label}: {r:.2f} of tolerance "
                          f"{'ok' if r <= 1.0 else 'FAIL'}", flush=True)
        for i in ([] if args.long else shapes) + (c.LONG_SHAPES if args.long else []):
            if args.long:
                label, arch, new, window = i
                q, kc, vc, kn, vn, kw = c.long_inputs(arch, new, seed=2299)
                kw.update(c.long_offsets(new, c.LONG_POS + 1), window=window)
                B, T = 1, c.LONG_T
            else:
                label, arch, smoke, B, T, S, new, kvv0d = c.DECODE_CASES[i]
                q, kc, vc, kn, vn, kw = c._decode_inputs(arch, smoke, B, T, S, new, kvv0d,
                                                         torch.bfloat16, seed=400 + T,
                                                         full=True)
            ref = decode_attention_ref(q, kc, vc, kn, vn, **kw)
            base = plan_of(q, kc, new, kw["window"])
            for n in [None] + clusters:
                launch = base if n is None else with_cluster(base, n)
                kernel.launch_for = lambda *_, fixed=launch, **__: fixed
                try:
                    r = c.decode_ratio(decode_attention(q, kc, vc, kn, vn, **kw), ref,
                                       "bfloat16")
                    ms = c.graph_ms(lambda: decode_attention(q, kc, vc, kn, vn, **kw),
                                    reps=2 if T * B > 65536 else 10,
                                    iters=5 if T * B > 65536 else 20)
                finally:
                    kernel.launch_for = plan_of
                print(f"{name} {label}: graph {ms:.5f} ms, {r:.2f} of tolerance | "
                      f"{'plan' if n is None else 'forced'} {c.plan_text(launch)}", flush=True)


if __name__ == "__main__":
    main()
