#!/usr/bin/env python3
"""Plant faults in copies of B7 (expanded attention) and show that phase 3d catches each.

    python3 tools/expanded_faults.py

The library is built from
``src/repro_torch/kernels/expanded_attention/csrc/expanded_attention.cu``
(the forward) and ``expanded_attention_bwd.cu`` (the backward) and held
against its plain versions by ``chip_smoke.expanded_cases`` (phase 3d's
cases): it must pass.  Then each fault of :data:`FAULTS` is made in a copy
of its source under ``build/expanded_faults/`` where the script runs (every
OLD must occur exactly once and is replaced by its NEW; the copy includes
the repo's ``hopper.cuh`` by its absolute path), built, loaded in the
library's place beside the other source as it is, and held the same way:
it must fail at least one case, or stop phase 3d's check at once (two
calls that differ).  The faults: the forward's scores without
the rope term, dK_rope taken from one head instead of the sum over the
heads, the mask off by one (a query sees the key after its position), the
dK/dV kernel's second warpgroup reading P^T from the next stage's buffer
instead of its own, and the forward's second warpgroup writing its rows
over the first's.
Exits 1 if the library fails or a fault passes.  Numbers from this script
are the card's only when it runs there.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

HEADER = '#include "../../flash_attention/csrc/hopper.cuh"'
# name -> (the source it edits: "forward" or "backward", its (OLD, NEW) replacements)
FAULTS = {
    # S = Q K^T over the two nope boxes only: the rope box's 4 k-steps dropped
    "rope term dropped": ("forward", [
        ("for (int kc = 0; kc < 12; ++kc)\n      wgmma_ss<BN>(sc,",
         "for (int kc = 0; kc < 8; ++kc)\n      wgmma_ss<BN>(sc,")]),
    # the rope reduce reads head 0's share alone
    "dk_rope from one head": ("backward", [
        ("for (int n = 0; n < d.N; ++n) sum += src[n * step];",
         "for (int n = 0; n < 1; ++n) sum += src[n * step];")]),
    # the forward's mask lets a query see the key after its position
    "mask off by one": ("forward", [
        ("x = kp < p.T ? (kp <= rpos[e >> 1] ? x : MASKED) : -INFINITY;",
         "x = kp < p.T ? (kp <= rpos[e >> 1] + 1 ? x : MASKED) : -INFINITY;")]),
    # dK/dV's warpgroup 1 forms dS^T from the next stage's P^T buffer
    "P^T from the next stage": ("backward", [
        ("const float4* buf = pt_s + s * (8 * 128);",
         "const float4* buf = pt_s + ((s + 1) % S) * (8 * 128);")]),
    # the forward's warpgroup 1 stores its 64 rows over warpgroup 0's
    "rows of warpgroup 1 over warpgroup 0's": ("forward", [
        ("    const int row = r0 + 8 * r;\n    if (row >= p.S) continue;",
         "    const int row = r0 - BM * wg + 8 * r;\n    if (row >= p.S) continue;")]),
}


def planted(name: str, edits: list[tuple[str, str]], source: Path, into: Path) -> Path:
    """A copy of ``source`` with each (OLD, NEW) of ``edits`` made once."""
    text = source.read_text()
    for old, new in edits + [(HEADER, f'#include "{source.parent / HEADER.split(chr(34))[1]}"')]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    copy = into / re.sub(r"\W+", "_", name) / source.name
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    return copy


def use(kernel, backward, forward_source: Path, backward_source: Path) -> None:
    """Load the libraries built from these sources in the wrappers' places."""
    kernel.SOURCE, kernel._lib = forward_source, None
    backward.SOURCE, backward._lib = backward_source, None
    kernel._ready_devices.clear()
    backward._ready_devices.clear()


def main() -> None:
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.expanded_attention import backward, kernel

    c.phase_device()
    into = ROOT / "build" / "expanded_faults"
    library = {"forward": kernel.SOURCE, "backward": backward.SOURCE}
    variants = [("library", dict(library))]
    for name, (which, edits) in FAULTS.items():
        sources = dict(library)
        sources[which] = planted(name, edits, library[which], into)
        variants.append((name, sources))
    for _, sources in variants:
        for source in sources.values():
            build.build(source)
    bad = []
    for name, sources in variants:
        use(kernel, backward, sources["forward"], sources["backward"])
        c.say(f"== {name}: " + ", ".join(str(p.relative_to(ROOT)) for p in sources.values()))
        try:
            failed, worst, *_ = c.expanded_cases()
        except SystemExit:
            if name == "library":
                raise
            # a check that ends phase 3d at once (two calls on the same
            # inputs that differ, a layout copy) caught the fault
            failed, worst = ["phase 3d stopped: its FAIL line above"], float("inf")
        caught = bool(failed) != (name == "library")
        c.say(f"   {name}: {len(failed)} of {len(c.EXPANDED_CASES)} cases fail (worst at "
              f"{worst:.3g} of its tolerance)" + (f" ({'; '.join(failed)})" if failed else "")
              + ("" if caught else "  <-- WRONG"))
        if not caught:
            bad.append(name)
    use(kernel, backward, library["forward"], library["backward"])
    c.say(f"nvidia-smi: {c.nvidia_smi()}")
    if bad:
        raise SystemExit(f"not as expected: {bad}")


if __name__ == "__main__":
    main()
