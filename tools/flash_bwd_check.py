#!/usr/bin/env python3
"""Check and time B1's backward kernel alone on one card.

    python3 tools/flash_bwd_check.py [--no-sweep] [--no-train] [--variant A.cu ...]

Runs the parts of ``chip_smoke.py`` that hold the backward kernel, without
the other phases: phase 1 (the device), phase 2 (the build, with ptxas's
register and spill report), then 19a: the sweep of ``BWD_COMBOS`` at both
dtypes and every head dim against the plain version (``--no-sweep`` skips
it), and phi4-mini's training shape (two calls bit-identical, the time in a
CUDA graph and from Python, each kernel's device time, the bound, the plain
version and ``F.scaled_dot_product_attention``'s forward + backward).  Then,
unless ``--no-train``, one bf16 training step of the phi4-mini smoke config
on the card, which must launch B1's forward and backward and copy no input.
Each ``--variant`` is a copy of ``csrc/flash_attention_bwd.cu`` edited by
hand: it is built beside a copy of ``csrc/hopper.cuh``, loaded in place of
the library, and held and timed the same way after the library, in the
same process on the same card.  It exits non-zero on any failure.  Numbers
from this script are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def train_step_copies() -> None:
    """One bf16 training step of the phi4-mini smoke config on the card."""
    import chip_smoke as c
    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.kernels.flash_attention import backward, kernel
    from repro_torch.launch import serve
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.train_lib import batch_to_device

    cfg = dataclasses.replace(C.get("phi4-mini-3.8b", smoke=True), dtype="bfloat16")
    batch = SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=128)).batch(0)
    model = serve.init_params(cfg, seed=0, device="cuda")
    state = adamw_init(dict(model.named_parameters()))
    before = (kernel.launches, backward.launches, kernel.layout_copies)
    metrics = make_train_step(cfg, lr=1e-3)(model, state, batch_to_device(batch, "cuda"))[2]
    after = (kernel.launches, backward.launches, kernel.layout_copies)
    fwd, bwd, copies = (a - b for a, b in zip(after, before))
    c.say(f"-- bf16 train step, {cfg.name} smoke: loss {float(metrics['loss']):.4f}, B1 forward "
          f"{fwd} and backward {bwd} launches, layout copies {copies}")
    if not (fwd and bwd) or copies:
        c.fail("the training step did not launch B1's kernels, or copied an input")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--variant", action="append", default=[], type=Path)
    args = ap.parse_args()

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import backward

    c.phase_device()
    c.phase_build()
    variants = build.BUILD_DIR / "variants"
    variants.mkdir(parents=True, exist_ok=True)
    header = backward.SOURCE.parent / "hopper.cuh"
    (variants / header.name).write_text(header.read_text())
    copies = [variants / path.name for path in args.variant]
    for path, copy in zip(args.variant, copies):
        if path.resolve() != copy.resolve():
            copy.write_text(path.read_text())
    for source in [backward.SOURCE, *copies]:
        backward.SOURCE, backward._fn = source, None
        c.say(f"==== {source.name}")
        if not args.no_sweep:
            c.train_kernel_sweep()
        c.train_kernel_timing()
    if not args.no_train:
        train_step_copies()
    c.say(f"nvidia-smi: {c.nvidia_smi()}")


if __name__ == "__main__":
    main()
