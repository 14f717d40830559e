"""Serving launcher: batched requests through the port's serving engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
        --smoke --device cpu --dtype float32

``--arch`` takes the architectures the engine serves: the dense, MoE and
vlm families (text prompts); at full size the MoE ones and llava-next need
more than one card holds.  The engine refuses the audio, hybrid and ssm
families, which run batch ``decode_step`` instead.

Runs on the card unless ``--device cpu`` is given (use ``--smoke`` there).
The weights are random, drawn on the target device from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.models import init_model
from repro_torch.serving import Request, ServingEngine


def init_params(cfg, *, seed: int = 0, device="cuda"):
    """Random weights for ``cfg``, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_model(gen, cfg, device=device)


def make_requests(cfg, n: int, *, max_new: int, seed: int = 0,
                  min_len: int = 4, max_len: int = 30) -> list[Request]:
    """``n`` requests with numpy-seeded prompt lengths in
    ``[min_len, max_len)`` and random tokens below ``cfg.vocab``."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, int(rng.integers(min_len, max_len))).astype(np.int64),
            max_new_tokens=max_new,
        )
        for i in range(n)
    ]


def serve(engine: ServingEngine, reqs: list[Request]) -> dict:
    """Submit ``reqs``, drain the engine; returns the finished requests
    and the run's metrics (times in seconds, on the host clock after the
    device finished)."""
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    wall = time.perf_counter() - t0
    st = engine.stats
    return {
        "done": done,
        "wall_s": wall,
        "decode_steps": st.steps,
        "decode_tok_per_s": st.decode_tok_per_s,
        "ttft_p50_s": float(np.percentile([r.t_first - r.t_submit for r in done], 50)),
        "ttft_p99_s": float(np.percentile([r.t_first - r.t_submit for r in done], 99)),
        "latency_p50_s": float(np.percentile([r.t_done - r.t_submit for r in done], 50)),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = dataclasses.replace(C.get(args.arch, smoke=args.smoke), dtype=args.dtype)
    params = init_params(cfg, seed=args.seed, device=args.device)

    t0 = time.perf_counter()
    engine = ServingEngine(
        cfg, params, max_slots=args.slots, max_len=args.max_len,
        prompt_buckets=(16, 32), device=args.device,
    )
    print(f"seal prefill x{len(engine.prompt_buckets)} + decode on {engine.device}: "
          f"{time.perf_counter() - t0:.1f}s")

    res = serve(engine, make_requests(cfg, args.requests, max_new=args.max_new,
                                      seed=args.seed))
    print(f"served {len(res['done'])} requests in {res['wall_s']:.2f}s | "
          f"decode steps {res['decode_steps']} | "
          f"{res['decode_tok_per_s']:,.0f} tok/s decode")
    print(f"TTFT p50 {res['ttft_p50_s']*1e3:.1f}ms p99 {res['ttft_p99_s']*1e3:.1f}ms | "
          f"latency p50 {res['latency_p50_s']*1e3:.1f}ms")


if __name__ == "__main__":
    main()
