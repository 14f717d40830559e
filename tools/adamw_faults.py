#!/usr/bin/env python3
"""Plant faults in copies of B4 (AdamW) and show that phase 19f catches each.

    python3 tools/adamw_faults.py [--fault NAME ...] [--edit 'NAME:OLD=>NEW' ...]
        [--no-phi4]

The library is built from ``src/repro_torch/kernels/adamw/csrc/adamw.cu``
and held against its plain version by ``chip_smoke.adamw_check`` (19f's
cases, ``chip_smoke.ADAMW_CASES``): it must pass.  Then each fault of
:data:`FAULTS` (all of them, or those named by ``--fault``) and each
``--edit`` is made in a copy of the source under ``build/adamw_faults/``
where the script runs (every OLD must occur exactly once and is replaced by
its NEW), built, loaded in the library's place and held the same way: it
must fail at least one case.  ``--no-phi4`` leaves out the cases at
phi4-mini's leaf sizes.  Exits 1 if the library fails or a fault passes.
Numbers from this script are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# name -> the (OLD, NEW) replacements that plant it in adamw.cu
FAULTS = {
    # the clipped gradient left unscaled
    "clip scale not applied": [("if (clip) g = round_to<T>(__fmul_rn(g, gscale));",
                                "if (false) g = round_to<T>(__fmul_rn(g, gscale));")],
    # m/bc1 and v/bc2 taken as m and v
    "bias correction skipped": [("const float mhat = __fdiv_rn(m2, bc1);",
                                 "const float mhat = m2;"),
                                ("const float vhat = __fdiv_rn(v2, bc2);",
                                 "const float vhat = v2;")],
    # a bf16 parameter stored truncated instead of rounded to nearest even
    "bf16 store truncates": [("__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]))",
                              "(__float_as_uint(x[2 * k]) >> 16)"),
                             ("__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]))",
                              "(__float_as_uint(x[2 * k + 1]) >> 16)")],
    # the elements after a leaf's last whole vector left out of its sum
    "tail left out of the sum": [("if (blockIdx.x == 0 && threadIdx.x == 0) add_tail<T>(",
                                  "if (false) add_tail<T>(")],
}


def planted(name: str, edits: list[tuple[str, str]], source: Path, into: Path) -> Path:
    """A copy of ``source`` with each (OLD, NEW) of ``edits`` made once."""
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    copy = into / name.replace(" ", "_") / "adamw.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    return copy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", action="append", default=[], choices=sorted(FAULTS))
    ap.add_argument("--edit", action="append", default=[], metavar="NAME:OLD=>NEW")
    ap.add_argument("--no-phi4", action="store_true")
    args = ap.parse_args()

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.adamw import kernel

    c.phase_device()
    cases = [case for case in c.ADAMW_CASES
             if not (args.no_phi4 and set(case[1]) & set(c.ADAMW_PHI4))]
    faults = {name: FAULTS[name] for name in (args.fault or FAULTS)}
    for edit in args.edit:
        name, change = edit.split(":", 1)
        faults[name] = [tuple(change.split("=>", 1))]
    into = ROOT / "build" / "adamw_faults"
    variants = [("library", kernel.SOURCE)] + [
        (name, planted(name, edits, kernel.SOURCE, into)) for name, edits in faults.items()]
    for _, source in variants:
        build.build(source)
    bad = []
    for name, source in variants:
        kernel.SOURCE, kernel._lib = source, None
        kernel._ready_devices.clear()
        c.say(f"== {name}: {source.relative_to(ROOT)}")
        failed = c.adamw_check(cases)
        caught = bool(failed) != (name == "library")
        c.say(f"   {name}: {len(failed)} of {len(cases)} cases fail"
              + (f" ({', '.join(failed)})" if failed else "")
              + ("" if caught else "  <-- WRONG"))
        if not caught:
            bad.append(name)
    c.say(f"nvidia-smi: {c.nvidia_smi()}")
    if bad:
        raise SystemExit(f"not as expected: {bad}")


if __name__ == "__main__":
    main()
