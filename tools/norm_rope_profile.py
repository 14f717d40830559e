#!/usr/bin/env python3
"""The training step's element-wise kernels by chain, and its replay time,
from one or more checkouts of the port in turns, on one card.

    python3 tools/norm_rope_profile.py [--roots build/parent,.,.,build/parent]
        [--archs phi4,deepseek] [--replays 20] [--out build/norm_rope_profile.json]

For each root in ``--roots``, and each arch, a child process with that
root's ``src/`` first on the path (and this checkout's ``chip_smoke.py``
beside it) builds the root's kernels (one nvcc a source, all at once, into
the root's own ``build/``), makes ``chip_smoke.py``'s 19c step (phi4-mini
full width and depth, bf16, 2 x 512 tokens) or 19h step (deepseek-v2 full
width, 1 layer, 2 x 4096 tokens) from seed 0's weights, and prints one JSON
line:

* ``eager_ms``, ``eager_peak_gib``: two eager steps (the host clock,
  synchronised) and their peak memory;
* ``chains``: one more eager step under the profiler, its element-wise
  kernels by the chain that launched them, beside each chain's bytes
  bound (``chip_smoke.chain_breakdown``, ``chain_bytes``);
* ``replay_ms``: the step sealed as one CUDA graph, each of ``--replays``
  replays on CUDA events; ``replay_kernel_ms``, ``replay_elementwise_ms``
  and ``replay_b8_b9_ms``: one profiled replay's kernels, all, those
  neither a product nor a kernel of the port's, and B8's and B9's;
  ``replay_loss``: the loss of the last replay, each replay a step on the
  first batch.

Unpack the parent commit first (``git archive HEAD~1 | tar -x -C
build/parent``) to compare it with this tree: parent, change, change,
parent.  The card's name and power limit open the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(root: str, arch: str, replays: int) -> dict:
    sys.path[:0] = [str((ROOT / root).resolve() / "src"), str(ROOT)]
    import dataclasses
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import chip_smoke as c
    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.kernels import KERNEL_MODULES, build
    from repro_torch.launch import serve
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.training import make_train_step, seal_train_step
    from repro_torch.training.train_lib import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib

    sources = sorted({getattr(importlib.import_module(m), "SOURCE", None)
                      for m in KERNEL_MODULES.values()} - {None})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    build_s = time.perf_counter() - t0
    if arch == "phi4":
        cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
        batch_size, seq = c.TRAIN_BATCH, c.TRAIN_SEQ
    else:
        cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=c.TRAIN_MLA_LAYERS,
                                  dtype="bfloat16")
        batch_size, seq = c.TRAIN_MLA_BATCH, c.TRAIN_MLA_SEQ
    data = SyntheticLM(data_config_for(cfg, batch_size=batch_size, seq_len=seq))
    batches = [data.batch(i) for i in range(4)]
    tokens = batch_size * seq

    def lr(step):
        return cosine_schedule(step, peak_lr=c.TRAIN_LR, warmup_steps=c.TRAIN_WARMUP,
                               total_steps=20)

    def fresh():
        model = serve.init_params(cfg, seed=0, device="cuda")
        return model, adamw_init(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, lr=lr)
    model, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    eager_ms = []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn(model, state, batch_to_device(batches[i], "cuda"))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, chains = c.chain_breakdown(
        lambda: step_fn(model, state, batch_to_device(batches[2], "cuda"))[2], f"{root} {arch}",
        c.chain_bytes(cfg, tokens))
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    model, state = fresh()
    sealed = seal_train_step(step_fn, model, state, batches[0])
    times = [c.time_ms(sealed.graph.replay, 1, warmup=1 if i == 0 else 0) for i in range(replays)]
    loss = float(sealed.metrics["loss"])
    rows = c.by_kernel(c.kernels_in_replay(lambda: sealed()))
    total = sum(us for us, _, _ in rows)
    ew = sum(us for us, _, key in rows
             if not any(w in key.lower() for w in c.GEMM_NAMES + c.PORT_KERNEL_NAMES))
    b8_b9 = sum(us for us, _, key in rows if "rms_" in key or "rotary_" in key)
    return dict(root=root, arch=arch, build_s=build_s, eager_ms=eager_ms, eager_peak_gib=peak,
                replay_ms=times, replay_ms_median=float(np.median(times)), replay_loss=loss,
                replay_kernel_ms=total / 1e3, replay_elementwise_ms=ew / 1e3,
                replay_b8_b9_ms=b8_b9 / 1e3,
                replay_kernels=sum(n for _, n, _ in rows), **chains)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", default=".")
    ap.add_argument("--archs", default="phi4,deepseek")
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--out", default="build/norm_rope_profile.json")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "ARCH"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(*args.child, args.replays)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results = []
    for arch in args.archs.split(","):
        for root in args.roots.split(","):
            proc = subprocess.run([sys.executable, __file__, "--child", root, arch, "--replays",
                                   str(args.replays)], capture_output=True, text=True)
            print(proc.stdout + proc.stderr[-4000:], flush=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode or not lines:
                sys.exit(f"{root} {arch}: rc {proc.returncode}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
    for r in results:
        top = ", ".join(f"{k} {v['ms']:.3f}" for k, v in r["chains"].items())
        print(f"{r['arch']} {r['root']}: replay {r['replay_ms_median']:.3f} ms (CUDA events, "
              f"median of {len(r['replay_ms'])}), kernels {r['replay_kernel_ms']:.3f} ms, "
              f"element-wise {r['replay_elementwise_ms']:.3f}, B8 and B9 "
              f"{r['replay_b8_b9_ms']:.3f}, the last replay's loss {r['replay_loss']:.4f}; eager "
              f"{r['eager_ms']} ms, peak "
              f"{r['eager_peak_gib']:.2f} GiB; eager element-wise by chain: {top}")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, results=results), indent=1))


if __name__ == "__main__":
    main()
