#!/usr/bin/env python3
"""Check and time B7 (expanded attention) against its parent design, paired, on one card.

    python3 tools/expanded_variants.py [--rev REV] [--check] [--no-time]
        [--variants NAME,...] [--out PATH]

The parent.  In a git checkout, the B7 package of commit ``REV`` (default
HEAD: before a commit, the design the working tree replaces) is written
with ``git show`` under ``build/expanded_variants/parent/b7_parent/`` (its
Python wrappers and both ``.cu`` sources), beside that commit's shared
``hopper.cuh`` at the relative path the sources include, and imported
from there.  In a copy without ``.git`` (a run on the card), the copy
written before is used; without one the script stops.  Both designs'
libraries are built (one ``nvcc`` each, together) and ptxas's registers,
spills and serialization notes are printed for every kernel.

``--check`` holds every case of phase 3d (``chip_smoke.EXPANDED_CASES``)
on the parent's kernels, then on the working tree's, as phase 3d does:
the output, the LSE and the five gradients against the plain version,
each call twice for the same bits.

Unless ``--no-time``, at the shapes phase 3d times (19h's, a 16x16
device's train_4k share) the designs run in turns, parent / change /
change / parent: the forward and the forward + backward in a CUDA graph
(``chip_smoke.graph_ms``), and each kernel's device time a launch under
the profiler over three forward + backward calls.  Then each variant of
``--variants`` (default all of ``VARIANTS``) is built from an edited copy
of the working tree's source and timed the same way beside it: the
forward at 128 keys a tile, and for the forward, dK/dV and dQ kernels
their products removed (the loads, the hand-offs and the softmax alone)
and their loads removed (the products alone).  A variant that removes a
part computes nothing right: it is timed, never checked.

The results also go to ``--out`` as JSON (default
``build/expanded_variants.json``).  Numbers from this script are the
card's only when it runs there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PARENT = ROOT / "build" / "expanded_variants" / "parent"
PACKAGE = "src/repro_torch/kernels/expanded_attention"
FILES = ("__init__.py", "kernel.py", "backward.py", "ops.py", "ref.py",
         "csrc/expanded_attention.cu", "csrc/expanded_attention_bwd.cu")
HEADER = "src/repro_torch/kernels/flash_attention/csrc/hopper.cuh"
# the phase 3d cases timed: 19h's shape and a 16x16 device's train_4k share
TIMED = (0, 1)

_FWD_QK = ("      wgmma_ss<BN>(sc, desc_kmajor<192, BM>(sQw, kc), desc_kmajor<192, BN>(sK + s * "
           "K_TILE, kc),\n                   kc > 0);")
_FWD_PV = "      wgmma_rs<128>(acc, pa[kc], desc_mnmajor<128, BN>(sV + s * V_TILE, kc));"
_FWD_K = ("        mbar_expect_tx(k_full(s), (nb + 1) * KV_BOX);\n"
          "        for (int c = 0; c < nb; ++c)\n"
          "          tma_load(k_at + c * KV_BOX, &maps.kn, c * BOX, t * BN, h, b, k_full(s));\n"
          "        tma_load(k_at + ROPE_BOX * KV_BOX, &maps.kr, 0, t * BN, 0, b, k_full(s));\n")
_FWD_V = ("        mbar_expect_tx(v_full(s), vb * KV_BOX);\n"
          "        for (int c = 0; c < vb; ++c)\n"
          "          tma_load(v_at + c * KV_BOX, &maps.v, c * BOX, t * BN, h, b, v_full(s));\n")
_DKDV_S = ("      wgmma_ss<64>(st, desc_kmajor<192, BN>(sK, kc), desc_kmajor<192, BM>(q_at(s), "
           "kc), kc > 0);")
_DKDV_DP = ("      wgmma_ss<64>(st, desc_kmajor<128, BN>(sV, kc), desc_kmajor<128, BM>(do_at(s), "
            "kc), kc > 0);")
_DKDV_DV = "      wgmma_rs<128>(accA, xa[kc], desc_mnmajor<128, BM>(do_at(s), kc));"
_DKDV_DK = ("      wgmma_rs<128>(accA, xa[kc], desc_mnmajor<128, BM>(q_at(s), kc));\n"
            "      wgmma_rs<64>(accB, xa[kc], desc_mnmajor<64, BM>(q_at(s) + ROPE_BOX * "
            "BOX_BYTES, kc));")
_DKDV_LOAD = ("    if (lane == 0) {\n"
              "      mbar_expect_tx(full(s), (nb + 1 + vb) * BOX_BYTES);\n"
              "      load_qk(q_at(s), &maps.qn, &maps.qr, nb, q0, h, h, b, full(s));\n"
              "      load_v(do_at(s), &maps.dO, vb, q0, h, b, full(s));\n"
              "    } else {\n"
              "      mbar_arrive(full(s));\n"
              "    }\n")

_DQ_S = ("      wgmma_ss<64>(sc, desc_kmajor<192, BM>(sQ, kc), desc_kmajor<192, BN>(k_at(s), kc), "
         "kc > 0);")
_DQ_DP = ("      wgmma_ss<64>(dp, desc_kmajor<128, BM>(sdO, kc), "
          "desc_kmajor<128, BN>(v_at(s), kc), kc > 0);")
_DQ_DQ = ("      wgmma_rs<128>(dqn, sa[kc], desc_mnmajor<128, BN>(k_at(s), kc));\n"
          "      wgmma_rs<64>(dqr, sa[kc], desc_mnmajor<64, BN>(k_at(s) + ROPE_BOX * "
          "BOX_BYTES, kc));")
_DQ_LOAD = ("    mbar_expect_tx(full(s), (nb + 1 + vb) * BOX_BYTES);\n"
            "    load_qk(k_at(s), &maps.kn, &maps.kr, nb, i * BN, h, 0, b, full(s));\n"
            "    load_v(v_at(s), &maps.v, vb, i * BN, h, b, full(s));\n")

def _keep(desc: str) -> str:
    """A statement that keeps a descriptor's arithmetic and issues nothing."""
    return f'asm volatile("" ::"l"({desc}));'


# NAME -> (the source it edits: "forward" or "backward", its (OLD, NEW)
# edits, the forward wrapper's constants to set while it runs)
VARIANTS = {
    # 128 keys a tile and two stages (the same 160 KB of ring as 64 keys and four)
    "fwd_keys128": ("forward", [("constexpr int BN = 64; ", "constexpr int BN = 128; "),
                                ("constexpr int STAGES = 4; ", "constexpr int STAGES = 2; ")],
                    {"KEYS": 128, "STAGES": 2}),
    # the forward's products removed: the loads, the turns and the softmax
    "fwd_no_products": ("forward", [
        (_FWD_QK, "      " + _keep("desc_kmajor<192, BN>(sK + s * K_TILE, kc)")),
        (_FWD_PV, "      " + _keep("desc_mnmajor<128, BN>(sV + s * V_TILE, kc)"))], {}),
    # the forward's K and V loads removed (the producer completes each
    # stage's barrier at once): the products, the turns and the softmax
    "fwd_no_loads": ("forward", [(_FWD_K, "        mbar_arrive(k_full(s));\n"),
                                 (_FWD_V, "        mbar_arrive(v_full(s));\n")], {}),
    # dK/dV's products removed: the ring, the P^T hand-off and the passes
    "dkdv_no_products": ("backward", [
        (_DKDV_S, "        " + _keep("desc_kmajor<192, BN>(sK, kc)")),
        (_DKDV_DP, "        " + _keep("desc_kmajor<128, BN>(sV, kc)")),
        (_DKDV_DV, "          " + _keep("desc_mnmajor<128, BM>(do_at(s), kc)")),
        (_DKDV_DK, "          " + _keep("desc_mnmajor<128, BM>(q_at(s), kc)"))], {}),
    # dK/dV's Q and dO loads removed (the rows still written): the products alone
    "dkdv_no_loads": ("backward", [(_DKDV_LOAD, "    mbar_arrive(full(s));\n")], {}),
    # dQ's products removed: the ring and the passes
    "dq_no_products": ("backward", [
        (_DQ_S, "      " + _keep("desc_kmajor<192, BN>(k_at(s), kc)")),
        (_DQ_DP, "      " + _keep("desc_kmajor<128, BN>(v_at(s), kc)")),
        (_DQ_DQ, "        " + _keep("desc_mnmajor<128, BN>(k_at(s), kc)"))], {}),
    # dQ's K and V loads removed: the products and the passes
    "dq_no_loads": ("backward", [(_DQ_LOAD, "    mbar_arrive(full(s));\n")], {}),
}


def extract(rev: str) -> str:
    """The parent's B7 package under ``PARENT``, from ``git show`` in a git
    checkout, else the copy written before; returns its commit."""
    stamp = PARENT / "REV"
    if not (ROOT / ".git").exists():
        if not stamp.is_file():
            raise SystemExit(f"no parent under {PARENT}: run this script once in a git checkout "
                             "first (it writes the parent there)")
        return stamp.read_text().strip()

    def git(*args: str) -> str:
        return subprocess.run(["git", "-C", str(ROOT), *args], capture_output=True, text=True,
                              check=True).stdout

    sha = git("rev-parse", rev).strip()
    shutil.rmtree(PARENT, ignore_errors=True)
    for name in FILES:
        dst = PARENT / "b7_parent" / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(git("show", f"{sha}:{PACKAGE}/{name}"))
    header = PARENT / "flash_attention" / "csrc" / "hopper.cuh"
    header.parent.mkdir(parents=True, exist_ok=True)
    header.write_text(git("show", f"{sha}:{HEADER}"))
    stamp.write_text(sha + "\n")
    return sha


def edited(name: str, edits: list[tuple[str, str]], source: Path) -> Path:
    """A copy of ``source`` under ``build/expanded_variants/NAME/`` with each
    (OLD, NEW) made once, beside a copy of the shared header at the relative
    path the source includes."""
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    into = ROOT / "build" / "expanded_variants" / name
    copy = into / "expanded_attention" / "csrc" / source.name
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    header = ROOT / HEADER
    shared = into / "flash_attention" / "csrc" / "hopper.cuh"
    shared.parent.mkdir(parents=True, exist_ok=True)
    shared.write_text(header.read_text())
    return copy


@contextlib.contextmanager
def using(kernel, backward, forward_source=None, backward_source=None, consts=None):
    """B7's wrappers as ``kernel`` and ``backward`` for the code that imports
    them from the package (``chip_smoke``'s phase 3d), loading the libraries
    built from the sources given (default their own) with the forward
    wrapper's constants ``consts`` set."""
    import repro_torch.kernels.expanded_attention as pkg

    kept = (pkg.kernel, pkg.backward, kernel.SOURCE, backward.SOURCE,
            {k: getattr(kernel, k) for k in consts or {}})

    def load(fwd, bwd, values):
        kernel.SOURCE, kernel._lib = fwd, None
        backward.SOURCE, backward._lib = bwd, None
        kernel._ready_devices.clear()
        backward._ready_devices.clear()
        for k, v in values.items():
            setattr(kernel, k, v)
        kernel.choose_launch.cache_clear()
        backward.choose_launch.cache_clear()

    pkg.kernel, pkg.backward = kernel, backward
    load(forward_source or kernel.SOURCE, backward_source or backward.SOURCE, consts or {})
    try:
        yield
    finally:
        pkg.kernel, pkg.backward = kept[0], kept[1]
        load(kept[2], kept[3], kept[4])


def short(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    found = re.search(r"exp_\w+", name)
    return found[0] if found else name[:40]


def time_design(c, torch, kernel, backward, case, seed: int) -> dict:
    """The forward and the forward + backward of one design at ``case`` in a
    CUDA graph, and each kernel's device ms a launch under the profiler."""
    label, B, S, N, nope, rope, dv, dname, kind = case
    *ten, do, scale = c._expanded_inputs(B, S, N, nope, rope, dv, dname, kind, seed)

    def forward():
        return kernel.attend(*ten, scale=scale, with_lse=True)

    def both():
        o, lse = kernel.attend(*ten, scale=scale, with_lse=True)
        return backward.expanded_attention_bwd(*ten[:5], o, lse, do, ten[5], scale=scale)

    with torch.no_grad():
        row = {"forward": c.graph_ms(forward, 2, 5), "both": c.graph_ms(both, 2, 5)}
        events = c.kernels_in_one(lambda: [both() for _ in range(3)], check=False)
    row["kernels"] = {short(name): us / count / 1e3 for us, count, name in c.by_kernel(events)
                      if "exp_" in name}
    del ten, do
    torch.cuda.empty_cache()
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "expanded_variants.json"))
    args = ap.parse_args()

    sha = extract(args.rev)
    sys.path.insert(0, str(PARENT))
    import b7_parent
    import chip_smoke as c
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.expanded_attention import backward, kernel

    c.phase_device()
    card = c.nvidia_smi()
    designs = {"parent": (b7_parent.kernel, b7_parent.backward),
               "change": (kernel, backward)}
    names = [n for n in args.variants.split(",") if n]
    variants = {}
    for name in names:
        which, edits, consts = VARIANTS[name]
        src = kernel.SOURCE if which == "forward" else backward.SOURCE
        variants[name] = (which, edited(name, edits, src), consts)
    sources = [m.SOURCE for pair in designs.values() for m in pair]
    sources += [path for _, path, _ in variants.values()]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    result = {"card": card, "parent": sha, "ptxas": {}, "check": {}, "times": [],
              "variants": {}}
    libraries = [(name, [k.SOURCE, b.SOURCE]) for name, (k, b) in designs.items()]
    libraries += [(name, [path]) for name, (_, path, _) in variants.items()]
    for name, paths in libraries:
        rep = c.expanded_registers(paths)
        result["ptxas"][name] = rep
        c.say(f"ptxas, {name}: " + "; ".join(
            f"{n} {r.get('registers')} registers, spills {r.get('spills')}"
            + (" SERIALIZED" if r.get("serialized") else "") for n, r in sorted(rep.items())))
        # ptxas's own words for each serialization note
        logs = [build.build_log(path) for path in paths]
        notes = sorted({line.strip() for log in logs for line in log.splitlines()
                        if "serialized" in line or any(code in line for code in c.SERIALIZING)})
        for line in notes:
            c.say(f"   {line[:400]}")

    if args.check:
        for name, (k, b) in designs.items():
            c.say(f"== check: phase 3d's cases on the {name}'s kernels")
            with using(k, b):
                failed, worst, errs, launched = c.expanded_cases()
            result["check"][name] = {"failed": failed, "worst": worst, "max_abs_err": errs,
                                     "launched": sorted(map(list, launched))}
            c.say(f"   {name}: {len(failed)} of {len(c.EXPANDED_CASES)} cases outside their "
                  f"tolerance (worst at {worst:.3g}){': ' + '; '.join(failed) if failed else ''}")

    if not args.no_time:
        for i in TIMED:
            case = c.EXPANDED_CASES[i]
            runs = []
            for name in ("parent", "change", "change", "parent"):
                k, b = designs[name]
                with using(k, b):
                    row = time_design(c, torch, k, b, case, seed=790 + case[2])
                runs.append((name, row))
                c.say(f"  {case[0]} | {name}: forward {row['forward']:.5f} ms, forward + "
                      f"backward {row['both']:.5f} | " + ", ".join(
                          f"{n} {ms:.5f}" for n, ms in sorted(row["kernels"].items())))
            result["times"].append({"case": case[0], "runs": runs})
            for name, (which, path, consts) in variants.items():
                fwd = path if which == "forward" else None
                bwd = path if which == "backward" else None
                with using(kernel, backward, fwd, bwd, consts):
                    row = time_design(c, torch, kernel, backward, case, seed=790 + case[2])
                result["variants"].setdefault(name, []).append({"case": case[0], **row})
                c.say(f"  {case[0]} | variant {name}: forward {row['forward']:.5f} ms, forward "
                      f"+ backward {row['both']:.5f} | " + ", ".join(
                          f"{n} {ms:.5f}" for n, ms in sorted(row["kernels"].items())))
    c.say(f"nvidia-smi: {card}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    bad = [n for n, r in result["check"].items() if r["failed"]]
    if bad:
        raise SystemExit(f"phase 3d's cases fail on {bad}")


if __name__ == "__main__":
    main()
