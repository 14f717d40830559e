"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --steps 100 --batch 2 --seq 512 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --smoke --device cpu --steps 20 --ckpt /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --model-axis 2 --batch 4 --seq 512

The counterpart of the JAX package's ``launch/train.py``, with the same
flags plus ``--device`` (default ``cuda``).  It seals ONE training step
ahead of time (``training.seal_train_step``: forward, backward, clipping
and AdamW as one CUDA graph on the card, the eager step on the CPU), then
the loop only copies each batch from the synthetic pipeline in and
replays, logging loss, ce, grad norm and tokens per second and writing
checkpoints.  The weights are random, drawn on the device from ``--seed``.

Under ``torchrun`` (``WORLD_SIZE`` > 1) it runs sharded, as JAX's trainer
over its mesh: one process a card (NCCL; gloo with ``--device cpu``),
``make_host_mesh(model_axis=N)`` of shape ``(world / N, N)``, the
parameters and the AdamW state as DTensors placed by their logical axes
(``repro_torch.distributed.shard_model``), every process drawing the same
weights and the same global batch from the seed and keeping its shards,
and the sharded step sealed.  Process 0 prints and writes the
checkpoint, which holds whole tensors.  Run alone, it trains on one
device, and ``--model-axis`` above 1 is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import Prefetcher, SyntheticLM, data_config_for
from repro_torch.distributed import shard_model
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.launch.serve import init_params
from repro_torch.models import param_axes
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.training import make_train_step, seal_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="", help="checkpoint dir (optional)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--dtype", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> list[float]:
    args = parser().parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world == 1 and args.model_axis > 1:
        raise SystemExit(f"--model-axis {args.model_axis} shards over processes: run under "
                         f"torchrun --nproc-per-node {args.model_axis} (or a multiple)")
    try:
        return train(args, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train(args, world: int) -> list[float]:
    cfg = C.get(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    mesh = None
    if world > 1:
        device = init_distributed(args.device)
        mesh = make_host_mesh(model_axis=args.model_axis, device=args.device)
    else:
        device = torch.device(args.device)
    lead = world == 1 or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    model = init_params(cfg, seed=args.seed, device=device)
    if mesh is not None:
        shard_model(model, param_axes(cfg), mesh)
    opt_state = adamw_init(dict(model.named_parameters()))

    def lr(step):
        return cosine_schedule(step, peak_lr=args.lr, warmup_steps=args.warmup,
                               total_steps=args.steps)

    step_fn = make_train_step(cfg, lr=lr, mesh=mesh)
    # every process draws the same global batch; the sealed step keeps its slice
    data = Prefetcher(SyntheticLM(data_config_for(cfg, batch_size=args.batch,
                                                  seq_len=args.seq, seed=args.seed)))

    # --- AoT scheduling: seal the step once --------------------------------
    example = next(data)
    sealed = seal_train_step(step_fn, model, opt_state, example)
    where = f"{device}" if mesh is None else f"a {tuple(mesh.shape)} mesh of {world} processes"
    say(f"sealed train step in {sealed.seal_s:.1f}s on {where} "
        f"({cfg.name}: {cfg.param_count / 1e6:.1f}M params"
        f"{', one CUDA graph' if sealed.graph is not None else ', eager'})")

    losses = []
    t_start = time.perf_counter()
    try:
        for step in range(args.steps):
            metrics = sealed(example if step == 0 else next(data))
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t_start
                tok_s = (step + 1) * args.batch * args.seq / dt
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"ce {float(metrics['ce']):.4f} gnorm {float(metrics['grad_norm']):.3f} "
                    f"tok/s {tok_s:,.0f}")
            if args.ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt, {"params": model}, step=step + 1)
    finally:
        data.close()

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    say(f"loss: first10={first:.4f} last10={last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": model}, step=args.steps)
        say(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
