#!/usr/bin/env python3
"""Check and time B8's backward against its parent design and its variants, paired, on one card.

    python3 tools/rms_bwd_variants.py [--rev REV] [--check] [--no-time]
        [--variants NAME,...] [--out PATH]

The parent.  In a git checkout, the B8 package of commit ``REV`` (default
HEAD: before a commit, the design the working tree replaces) is written
with ``git show`` under ``build/rms_bwd_variants/parent/b8_parent/`` and
imported from there.  In a copy without ``.git`` (a run on the card), the
copy written before is used; without one the script stops.  The parent's,
the working tree's and each source variant's libraries are built (one
``nvcc`` each, together), and ptxas's registers and spills are printed for
every B8 kernel.

``--check`` holds every case of phase 3e (``chip_smoke.NORM_CASES``) on
the working tree's kernels and under each plan variant, as phase 3e does:
forward and backward against the plain versions, each call twice for the
same bits.

Unless ``--no-time``, at the rows phase 3e times (19c's 1024 x 3072 and
19h's 8192 x 5120, bf16) the designs' backward runs in turns, parent /
change / change / parent, in a CUDA graph (``chip_smoke.graph_ms``), with
each kernel's device time a call under the profiler; then
``aten._fused_rms_norm_backward`` (a yardstick), and each variant of
``--variants`` (default all of ``VARIANTS``) beside them.  A plan variant
changes the launch only and computes the same function (``--check`` holds
it); a source variant is an edited copy of ``csrc/rms_norm.cu`` that
leaves a part out, and is timed, never checked; a design variant is an
edited copy that computes the same function another way, checked and
timed.  ``--check`` also fails where the working tree's plan assumed
another residency than the card's occupancy (phase 3e's rule).

The results also go to ``--out`` as JSON (default
``build/rms_bwd_variants.json``).  Numbers from this script are the card's
only when it runs there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PARENT = ROOT / "build" / "rms_bwd_variants" / "parent"
PACKAGE = "src/repro_torch/kernels/rms_norm"
FILES = ("__init__.py", "kernel.py", "backward.py", "ops.py", "ref.py", "csrc/rms_norm.cu")

_STORE_DX = "        store_group<T, VEC>(out, j, o);\n"
_STORE_TMA = "        store_group<T, true>(out, j, o);\n"
_PARTIAL = "  cluster_partial(part, width, p.partial);\n}\n"
_FINISH = ("  return (int)cudaLaunchKernelEx(&cfg, rms_dscale_kernel, (const float*)partial, "
           "grid / cluster,\n                                 width, dscale);")
_PDL_ROWS = "    cfg.numAttrs = pdl ? 2 : 1;\n"
_PDL_FINISH = "  cfg.numAttrs = 1;\n  return (int)cudaLaunchKernelEx(&cfg, rms_dscale_kernel,"
# the last-CTA finish: each CTA, once its cluster's columns are written,
# counts itself in its rank's counter; the last CTA of a rank sums those
# columns over every cluster's row in cluster order into dscale and sets the
# counter back to 0 for the next call.  The counter decides which CTA sums,
# not the order of the sum; no second kernel.
_BWD_STRUCT = "  float* partial;               // the clusters' d(scale) rows, clusters x width\n};"
_BWD_INIT = "const Bwd p{x, xs, dy, dys, rstd, rows, width, scale, offset, dx, partial};"
_CLUSTER_SIG = ("__device__ __forceinline__ void cluster_partial(float* part, long long width,\n"
                "                                                float* __restrict__ partial) {")
_CLUSTER_END = "  cl.sync();                    // no CTA leaves while another reads its row\n}"
_LAST_FINISH = """  cl.sync();
  __shared__ unsigned last;
  __threadfence();              // this CTA's columns are visible before it counts itself
  __syncthreads();
  const long long parts = gridDim.x / c;
  if (threadIdx.x == 0) {
    last = atomicAdd(&rms_fin_count[rank], 1u) == parts - 1;
    if (last) rms_fin_count[rank] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if ((width & 3) == 0) {
    const long long quads = width >> 2, per = (quads + c - 1) / c, lo = rank * per;
    const long long hi = lo + per < quads ? lo + per : quads;
    const float4* pq = reinterpret_cast<const float4*>(partial);
    for (long long q4 = lo + threadIdx.x; q4 < hi; q4 += blockDim.x) {
      float4 s = __ldcg(pq + q4);
#pragma unroll 8
      for (long long b = 1; b < parts; ++b) {
        const float4 v = __ldcg(pq + b * quads + q4);
        s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                        __fadd_rn(s.w, v.w));
      }
      reinterpret_cast<float4*>(dscale)[q4] = s;
    }
  } else {
    const long long per = (width + c - 1) / c, lo = rank * per;
    const long long hi = lo + per < width ? lo + per : width;
    for (long long col = lo + threadIdx.x; col < hi; col += blockDim.x) {
      float s = __ldcg(partial + col);
#pragma unroll 8
      for (long long b = 1; b < parts; ++b) s = __fadd_rn(s, __ldcg(partial + b * width + col));
      dscale[col] = s;
    }
  }
}"""


def fixed(kernel, plan, width: int, es: int, **changes):
    """``plan`` with ``changes`` (any of items, stages, cluster, grid, or
    ``per_sm``: the grid as that many blocks an SM); the threads, shared
    memory and whole clusters follow.  A plan of rms_bwd_kernel_wide stays
    as it is, the warp layout keeps its warps, and a plan with no ring
    keeps none."""
    if not plan.items:
        return plan
    items = changes.pop("items", plan.items)
    stages = changes.pop("stages", plan.stages)
    stages = stages if plan.stages else 0
    whole = width // (kernel.VEC // es)
    threads = plan.threads if plan.warp else 32 * -(-whole // (32 * items))
    plan = dataclasses.replace(plan, items=items, threads=threads, stages=stages,
                               smem=kernel.bwd_smem(width, es, plan.teams, stages),
                               **{k: v for k, v in changes.items() if k != "per_sm"})
    if "per_sm" in changes:
        plan = dataclasses.replace(plan, grid=kernel.SMS * changes["per_sm"])
    grid = max(1, plan.grid)
    c = max(x for x in (1, 2, 4, 8) if x <= min(plan.cluster, grid))
    return dataclasses.replace(plan, cluster=c, grid=grid // c * c)


# NAME -> ("plan", a function of (kernel, choose, rows, width, elem_bytes,
# vec) giving the plan to launch, ``choose`` the working tree's
# choose_backward), ("source", the (OLD, NEW) edits of csrc/rms_norm.cu,
# each made wherever OLD occurs, leaving a part out) or ("design", such
# edits computing the same function: ``--check`` holds it; a third entry,
# if any, is its plan as a "plan" variant's)
VARIANTS = {
    # neither kernel by programmatic dependent launch: each launched after the one before ends
    "no_pdl": ("source", [(_PDL_ROWS, "    cfg.numAttrs = 1;\n"),
                          (_PDL_FINISH, _PDL_FINISH.replace("= 1;", "= 0;"))]),
    # block rows through rms_bwd_kernel_wide (what rows off 16 bytes take): x and dy read
    # twice, d(scale) in shared memory, instead of the shared ring
    "wide": ("plan", lambda k, ch, r, w, es, vec: ch(r, w, es, False)),
    # a deeper ring; four groups a thread (fewer warps a row)
    "stages_4": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                            stages=4)),
    "items_4": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                           items=4)),
    # the partial rows in clusters of other sizes (cluster 1: each CTA its own row)
    "cluster_1": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                             cluster=1)),
    "cluster_2": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                             cluster=2)),
    "cluster_4": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                             cluster=4)),
    "cluster_8": ("plan", lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es,
                                                             cluster=8)),
    # half the blocks (more rows a block), and twice
    "grid_half": ("plan", lambda k, ch, r, w, es, vec: fixed(k, (p := ch(r, w, es, vec)), w, es,
                                                             grid=p.grid // 2)),
    "grid_double": ("plan", lambda k, ch, r, w, es, vec: fixed(k, (p := ch(r, w, es, vec)), w,
                                                               es, grid=p.grid * 2)),
    # dx not written: the rows read and d(scale) summed
    "no_dx": ("source", [(_STORE_DX, ""), (_STORE_TMA, "")]),
    # no partial rows: neither the cluster's sum nor its writes
    "no_partials": ("source", [(_PARTIAL, "}\n")]),
    # the rows kernel alone: no finish
    "no_finish": ("source", [(_FINISH, "  return 0;")]),
    # the last CTA of each rank sums its columns over the clusters' rows: one kernel a call
    "last_cta": ("design", [
        (_BWD_STRUCT, _BWD_STRUCT.replace("\n};", "\n  float* dscale;\n};")),
        (_BWD_INIT, _BWD_INIT.replace("partial};", "partial, dscale};")),
        (_CLUSTER_SIG, "__device__ unsigned rms_fin_count[MAX_CLUSTER];\n\n"
         + _CLUSTER_SIG.replace("partial) {", "partial,\n"
                                "                                                float* "
                                "__restrict__ dscale) {")),
        (_CLUSTER_END, _LAST_FINISH),
        ("cluster_partial(part, width, p.partial);", "cluster_partial(part, width, p.partial, p.dscale);"),
        ("cluster_partial(acc, width, p.partial);", "cluster_partial(acc, width, p.partial, p.dscale);"),
        (_FINISH, "  return 0;")]),
}
# the last-CTA finish in clusters of 8: the fewest partial rows for its one CTA a rank to sum
VARIANTS["last_cta_8"] = (*VARIANTS["last_cta"],
                          lambda k, ch, r, w, es, vec: fixed(k, ch(r, w, es, vec), w, es, cluster=8))
# --sweep: the plans timed at each timed case, every combination
SWEEP = {"items": (3, 4), "stages": (2, 3), "per_sm": (1, 2, 3), "cluster": (1, 2, 4)}


def extract(rev: str) -> str:
    """The parent's B8 package under ``PARENT``, from ``git show`` in a git
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
        dst = PARENT / "b8_parent" / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(git("show", f"{sha}:{PACKAGE}/{name}"))
    stamp.write_text(sha + "\n")
    return sha


def edited(name: str, edits: list[tuple[str, str]], source: Path) -> Path:
    """A copy of ``source`` under ``build/rms_bwd_variants/NAME/`` with each
    (OLD, NEW) made wherever OLD occurs."""
    text = source.read_text()
    for old, new in edits:
        if not text.count(old):
            raise SystemExit(f"{name}: the text {old!r} does not occur")
        text = text.replace(old, new)
    copy = ROOT / "build" / "rms_bwd_variants" / name / source.name
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    return copy


@contextlib.contextmanager
def using(kernel, source=None, plan=None):
    """The working tree's B8 with its library built from ``source`` (default
    its own) and its backward plans from ``plan`` (a function of (kernel,
    choose_backward, rows, width, elem_bytes, vec))."""
    kept = (kernel.SOURCE, getattr(kernel, "choose_backward", None))

    def load(src):
        kernel.SOURCE, kernel._lib = src, None
        kernel._ready_devices.clear()

    load(source or kept[0])
    if plan is not None:
        kernel.choose_backward = lambda rows, width, es, vec=True: plan(kernel, kept[1], rows,
                                                                          width, es, vec)
    try:
        yield
    finally:
        if plan is not None:
            kernel.choose_backward = kept[1]
        load(kept[0])


def short(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    found = re.search(r"rms_\w+", name)
    return found[0] if found else name[:40]


def time_backward(c, torch, bwd, case, profile: bool = True) -> dict:
    """One design's backward (``bwd``) at a phase 3e case in a CUDA graph,
    and (with ``profile``) each of its kernels' device ms a call under the
    profiler."""
    from repro_torch.kernels.rms_norm import kernel as b8

    label, lead, width, stride, dname, offset, base = case
    x, scale, dy = c.norm_inputs(lead, width, stride, dname, offset, base, seed=7)
    rstd = b8.rms_norm(x, scale, c.NORM_EPS, offset)[1]
    row = {"ms": c.graph_ms(lambda: bwd(x, scale, rstd, dy, offset))}
    if not profile:
        return row
    events = c.kernels_in_one(lambda: [bwd(x, scale, rstd, dy, offset) for _ in range(3)],
                              check=False)
    row["kernels"] = {short(name): us / count / 1e3 for us, count, name in c.by_kernel(events)
                      if "rms_" in name}
    return row


def sweep(c, torch, kernel, backward, case) -> list[dict]:
    """Every plan of ``SWEEP`` at ``case`` in a CUDA graph, with the card's
    occupancy for it (blocks an SM, clusters at once)."""
    import itertools

    label, lead, width, stride, dname, offset, base = case
    rows, es = int(torch.Size(lead).numel()), 2 if dname == "bfloat16" else 4
    base_plan = kernel.choose_backward(rows, width, es)
    out = []
    for values in itertools.product(*SWEEP.values()):
        change = dict(zip(SWEEP, values))
        plan = fixed(kernel, base_plan, width, es, **change)
        if plan.smem > kernel.MAX_SMEM or plan.threads > kernel.TEAM_THREADS:
            continue
        with using(kernel, plan=lambda *_: plan):
            row = time_backward(c, torch, backward.rms_norm_bwd, case, profile=False)
            occupancy = c.bwd_occupancy(plan, es)
        out.append({"case": label, "plan": str(plan), "occupancy": occupancy, **change, **row})
        c.say(f"  {label} | sweep {change}: {row['ms']:.5f} ms, occupancy {occupancy} | {plan}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=str(ROOT / "build" / "rms_bwd_variants.json"))
    args = ap.parse_args()

    sha = extract(args.rev)
    sys.path.insert(0, str(PARENT))
    import b8_parent
    import chip_smoke as c
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rms_norm import backward, kernel

    c.phase_device()
    card = c.nvidia_smi()
    names = [n for n in args.variants.split(",") if n]
    sources = {"parent": b8_parent.kernel.SOURCE, "change": kernel.SOURCE}
    sources.update({n: edited(n, VARIANTS[n][1], kernel.SOURCE) for n in names
                    if VARIANTS[n][0] != "plan"})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources.values()))
    result = {"card": card, "parent": sha, "ptxas": {}, "check": {}, "times": [], "library": [],
              "variants": {}}
    for name, path in sources.items():
        rep = c.ptxas_report([build.build_log(path)], c.norm_rope_kernel)
        result["ptxas"][name] = rep
        c.say(f"ptxas, {name}: " + "; ".join(
            f"{n} {r.get('registers')} registers, spills {r.get('spills')}"
            for n, r in sorted(rep.items()) if "bwd" in n or "dscale" in n))

    checked = {"change": {}}
    checked.update({n: {"plan": VARIANTS[n][1]} for n in names if VARIANTS[n][0] == "plan"})
    checked.update({n: {"source": sources[n], "plan": (VARIANTS[n][2:] or [None])[0]}
                    for n in names if VARIANTS[n][0] == "design"})
    if args.check:
        for name, how in checked.items():
            c.say(f"== check: phase 3e's B8 cases, {name}")
            with using(kernel, **how):
                worst = max(c.norm_check(*case, seed=i, plan_check=name == "change")[0]
                            for i, case in enumerate(c.NORM_CASES))
            result["check"][name] = worst
            c.say(f"   {name}: every case within tolerance, worst at {worst:.3f} of it")

    if not args.no_time:
        designs = {"parent": (b8_parent.kernel, b8_parent.backward.rms_norm_bwd),
                   "change": (kernel, backward.rms_norm_bwd)}
        for i in c.NORM_TIMED:
            case = c.NORM_CASES[i]
            rows = int(torch.Size(case[1]).numel())
            es = 2 if case[4] == "bfloat16" else 4
            nbytes = c.bwd_bytes(rows, case[2], es)
            bound = c.bound(10.0 * rows * case[2], nbytes, "float32")[0]
            runs = []
            for name in ("parent", "change", "change", "parent"):
                mod, bwd = designs[name]
                with using(mod):
                    row = time_backward(c, torch, bwd, case)
                runs.append((name, row))
                c.say(f"  {case[0]} | {name}: {row['ms']:.5f} ms, {bound / row['ms']:.1%} of the "
                      f"{bound:.5f} ms bound | " + ", ".join(
                          f"{n} {ms:.5f}" for n, ms in sorted(row["kernels"].items())))
            result["times"].append({"case": case[0], "bound_ms": bound, "runs": runs,
                                    "plan": str(kernel.choose_backward(rows, case[2], es))})
            x, scale, dy = c.norm_inputs(*case[1:], seed=7)
            wl = (case[5] + scale).to(x.dtype)
            rl = torch.ops.aten._fused_rms_norm(x, [case[2]], wl, c.NORM_EPS)[1]
            lib_ms = c.graph_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
                dy, x, [case[2]], rl, wl, [True, True]))
            result["library"].append({"case": case[0], "ms": lib_ms})
            c.say(f"  {case[0]} | aten._fused_rms_norm_backward, bf16 weight: {lib_ms:.5f} ms")
            del x, scale, dy
            for name in names:
                kind, what, *own = VARIANTS[name]
                with using(kernel, source=sources.get(name) if kind != "plan" else None,
                           plan=what if kind == "plan" else (own or [None])[0]):
                    row = time_backward(c, torch, backward.rms_norm_bwd, case)
                    plan = kernel.choose_backward(rows, case[2], es)
                result["variants"].setdefault(name, []).append(
                    {"case": case[0], "plan": str(plan), **row})
                c.say(f"  {case[0]} | variant {name}: {row['ms']:.5f} ms, {bound / row['ms']:.1%}"
                      f" of the bound | " + ", ".join(
                          f"{n} {ms:.5f}" for n, ms in sorted(row["kernels"].items()))
                      + f" | {plan}")
            if args.sweep:
                result.setdefault("sweep", []).extend(sweep(c, torch, kernel, backward, case))
            torch.cuda.empty_cache()
    c.say(f"nvidia-smi: {card}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))


if __name__ == "__main__":
    main()
