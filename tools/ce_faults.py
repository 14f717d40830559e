#!/usr/bin/env python3
"""Plant faults in copies of B5 (cross-entropy) and show that phase 19g catches each.

    python3 tools/ce_faults.py

The library is built from
``src/repro_torch/kernels/cross_entropy/csrc/cross_entropy.cu`` and held
against its plain version by ``chip_smoke.ce_check`` (19g's cases,
``chip_smoke.ce_cases``): it must pass.  Then each fault of :data:`FAULTS`
is made in a copy of the source under ``build/ce_faults/`` where the
script runs (every OLD must occur exactly once and is replaced by its
NEW), built, loaded in the library's place and held the same way: it must
fail at least one case.  The faults cover the forward's sum (a dropped
tail, a rescale skipped, the guard for -inf columns removed) and the
backward (the one-hot on the wrong shard, small exp(x - lse) flushed to 0,
the fast ``__expf``).  Exits 1 if the library fails or a fault passes.
Numbers from this script are the card's only when it runs there.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# name -> the (OLD, NEW) replacements that plant it in cross_entropy.cu
FAULTS = {
    # the columns after a row's last whole group of 4 left out of its sum
    "vector tail dropped": [
        ("for (long long e = 4 * groups; e < width; ++e) online_add1(m, s, xr[e]);", "")],
    # the backward's one-hot at the label's global column: on a shard that
    # does not start at 0 it lands on the wrong shard's columns
    "one-hot on the wrong shard": [("const long long col = (label < 0 ? 0 : label) - start;\n  for",
                                    "const long long col = (label < 0 ? 0 : label);\n  for")],
    # a thread's sum not rescaled when its running max grows
    "rescale skipped": [("s = __fmul_rn(s, expf(m - mx));", "s = s;")],
    # the backward's exp(x - lse) below 1e-6 written as 0
    "small exp flushed to 0": [("__fsub_rn(expf(x - lse), hit",
                                "__fsub_rn(x - lse < -13.815511f ? 0.0f : expf(x - lse), hit")],
    # the backward's exp taken by the fast intrinsic (an error that grows
    # with |x - lse|)
    "__expf in the backward": [("__fsub_rn(expf(x - lse), hit", "__fsub_rn(__expf(x - lse), hit")],
    # a thread whose values so far are all -inf adds exp(-inf - -inf) = NaN
    "guard for -inf removed": [
        ("  if (m == -INFINITY) return;\n  s = __fadd_rn(s, expf(v.x - m));",
         "  s = __fadd_rn(s, expf(v.x - m));"),
        ("  if (m == -INFINITY) return;\n  s = __fadd_rn(s, expf(x - m));",
         "  s = __fadd_rn(s, expf(x - m));")],
}


def planted(name: str, edits: list[tuple[str, str]], source: Path, into: Path) -> Path:
    """A copy of ``source`` with each (OLD, NEW) of ``edits`` made once."""
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    copy = into / name.replace(" ", "_") / "cross_entropy.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    return copy


def main() -> None:
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.cross_entropy import kernel

    c.phase_device()
    cases = c.ce_cases()
    into = ROOT / "build" / "ce_faults"
    variants = [("library", kernel.SOURCE)] + [
        (name, planted(name, edits, kernel.SOURCE, into)) for name, edits in FAULTS.items()]
    for _, source in variants:
        build.build(source)
    bad = []
    for name, source in variants:
        kernel.SOURCE, kernel._lib = source, None
        kernel._ready_devices.clear()
        c.say(f"== {name}: {source.relative_to(ROOT)}")
        failed = c.ce_check(cases)
        caught = bool(failed) != (name == "library")
        c.say(f"   {name}: {len(failed)} of {len(cases)} cases fail"
              + (f" ({'; '.join(failed)})" if failed else "")
              + ("" if caught else "  <-- WRONG"))
        if not caught:
            bad.append(name)
    c.say(f"nvidia-smi: {c.nvidia_smi()}")
    if bad:
        raise SystemExit(f"not as expected: {bad}")


if __name__ == "__main__":
    main()
