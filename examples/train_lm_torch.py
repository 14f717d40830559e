"""End-to-end example of the port: train an LM for a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu --steps 20

The PyTorch counterpart of ``examples/train_lm.py``: the config system,
the synthetic data pipeline with prefetch, AdamW with the cosine schedule,
a training step sealed ahead of time (one CUDA graph on the card: the loop
only copies batches in and replays) and checkpointing.  The model is
xlstm-125m at full size, float32, by default, on the card unless
``--device cpu`` is given; pass ``--arch stablelm-1.6b --smoke`` etc. for
others.
"""

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import Prefetcher, SyntheticLM, data_config_for
from repro_torch.launch.serve import init_params
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.training import make_train_step, seal_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="", help="checkpoint dir (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = dataclasses.replace(C.get(args.arch, smoke=args.smoke), dtype="float32")
    print(f"{cfg.name}: {cfg.param_count/1e6:.0f}M params, "
          f"{cfg.n_layers} layers, d_model={cfg.d_model}, on {args.device}")

    model = init_params(cfg, seed=0, device=args.device)
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(
        cfg,
        lr=lambda s: cosine_schedule(s, peak_lr=args.lr, warmup_steps=30,
                                     total_steps=args.steps),
    )

    data = Prefetcher(SyntheticLM(data_config_for(
        cfg, batch_size=args.batch, seq_len=args.seq)))
    example = next(data)

    sealed = seal_train_step(step_fn, model, opt, example)
    print(f"AoT: sealed train step in {sealed.seal_s:.1f}s")

    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        m = sealed(example if step == 0 else next(data))
        losses.append(float(m["loss"]))
        if step % 25 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"tok/s {(step+1)*args.batch*args.seq/dt:,.0f}")
    data.close()

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_lm_ckpt_")
    save_checkpoint(ckpt, {"params": model}, step=args.steps)
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.1 else 'no material progress'}); "
          f"checkpoint at {ckpt}")


if __name__ == "__main__":
    main()
