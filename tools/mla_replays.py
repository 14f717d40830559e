#!/usr/bin/env python3
"""DeepSeek-V2's served decode and prefill replays on one card, with the
device time of MLA's plain absorbed attention by stage, for two checkouts
in turns.

    python3 tools/mla_replays.py [--roots build/parent,.] [--order 0,1,1,0]

For each entry of ``--order`` (an index into ``--roots``) a child process
imports ``repro_torch`` from that checkout's ``src/`` and serves
deepseek-v2-236b as ``chip_smoke.py`` phase 9 does: full width, 2 of its 60
layers, bf16, random weights drawn on the card from seed 0, 4 slots of 1024
positions, buckets 64-512, the phase's 8 requests of 20-500 prompt tokens
and 16 new ones, every step a CUDA-graph replay.  Then it prints and
records:

* the decode replay's time (CUDA events, mean of 20 after warm-up) from
  two sets of slot offsets: the drained engine's (``drained``; phase 9
  times its replays there) and 1000, 980, 960 and 940 of the 1024
  positions (``near_full``), and each prefill bucket's (mean of 5);
* the kernels of one decode replay from each set of offsets and of one
  bucket-512 prefill replay (torch.profiler, ``chip_smoke.kernels_in_one``):
  their sum, B2's (``stream_pack_``) and B6's (``latent_``) shares, the top
  kernels;
* the plain absorbed form (``models/mla.py``'s core before B6) at those
  shapes, one layer, stage by stage from the functions of this
  checkout's ``kernels/latent_attention/ref.py``, each in a CUDA graph
  (``chip_smoke.graph_ms``): the ``.float()`` copies, the score einsums,
  the mask and ``where``, the softmax, the cast to bf16 and the context
  einsum, and the whole; beside it B6 where the served checkout has it.

Each child writes ``chiprun_out/mla_replays_<i>.json``; the parent prints
one line a run.  Numbers are the card's only when it runs there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "chiprun_out"
REF = HERE / "src" / "repro_torch" / "kernels" / "latent_attention" / "ref.py"
B2, B6 = "stream_pack_", "latent_"


def plain_stages(cs, q_lat, q_rope, ckv, krope, positions, kv_len, scale) -> dict:
    """ms in a CUDA graph of each stage of the plain absorbed form, and of
    the whole, from ``ref.py``'s own functions (this checkout's, loaded by
    path, so the parent's runs time the same expressions); B6 beside them
    where the served checkout has it."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("latent_ref", REF)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    f = [t.float() for t in (q_lat, q_rope, ckv, krope)]
    logits = ref.latent_logits(*f, scale=scale)
    masked = torch.where(ref.latent_mask(positions, kv_len, ckv.shape[1]), logits, ref.NEG_INF)
    probs = torch.softmax(masked, dim=-1)
    cast = probs.to(q_lat.dtype)
    stages = {
        "float_copies": lambda: [x.float() for x in (q_lat, q_rope, ckv, krope)],
        "score_einsums": lambda: ref.latent_logits(*f, scale=scale),
        "mask_where": lambda: torch.where(ref.latent_mask(positions, kv_len, ckv.shape[1]),
                                          logits, ref.NEG_INF),
        "softmax": lambda: torch.softmax(masked, dim=-1),
        "cast": lambda: probs.to(q_lat.dtype),
        "context_einsum": lambda: torch.einsum("bnst,btr->bsnr", cast, ckv),
        "whole": lambda: ref.latent_attention_ref(q_lat, q_rope, ckv, krope, positions,
                                                  kv_len, scale=scale),
    }
    out = {name: cs.graph_ms(fn, reps=5, iters=10) for name, fn in stages.items()}
    try:
        from repro_torch.kernels.latent_attention import latent_attention
    except ImportError:
        return out
    out["b6"] = cs.graph_ms(lambda: latent_attention(q_lat, q_rope, ckv, krope, positions,
                                                     kv_len, scale=scale), reps=5, iters=10)
    return out


def replay_kernels(cs, run) -> dict:
    rows = cs.by_kernel(cs.kernels_in_one(run))
    total = sum(us for us, _, _ in rows)
    top = sorted(rows, reverse=True)[:10]
    return dict(kernels=sum(c for _, c, _ in rows), kernel_ms=total / 1e3,
                b2_ms=sum(us for us, _, k in rows if B2 in k) / 1e3,
                b6_ms=sum(us for us, _, k in rows if B6 in k) / 1e3,
                b6_kernels=sum(c for _, c, k in rows if B6 in k),
                top=[(round(us / 1e3, 5), c, k[:100]) for us, c, k in top])


def child(root: Path, index: int) -> None:
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import chip_smoke as cs
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=2, dtype="bfloat16")
    params = serve.init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(cfg, params, max_slots=cs.SERVE_SLOTS, max_len=1024,
                           bucketing=f"pow2:{min(cs.PREFILL_BUCKETS)}:{max(cs.PREFILL_BUCKETS)}",
                           device="cuda")
    reqs = serve.make_requests(cfg, 8, max_new=16, seed=0, min_len=20, max_len=501)
    res = serve.serve(engine, reqs)
    cache = engine.kv_cache
    toks = torch.zeros((engine.max_slots, 1), dtype=torch.long)
    offsets = {"drained": cache["pos"].clone(),
               "near_full": torch.tensor([1000, 980, 960, 940], device=cache["pos"].device)}
    rec = dict(root=str(root), device=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi(),
               ttft_p50_ms=res["ttft_p50_s"] * 1e3, decode_tok_per_s=res["decode_tok_per_s"],
               decode={})
    for name, pos in offsets.items():
        def decode(pos=pos):
            cache["pos"].copy_(pos)
            return engine._decode(params, cache, toks)

        decode()
        cache["pos"].copy_(pos)
        rec["decode"][name] = dict(
            pos=pos.tolist(),
            replay_ms=cs.time_ms(lambda: engine._decode(params, cache, toks), 20),
            kernels=replay_kernels(cs, decode))
    rec["prefill_replay_ms"] = {}
    for b in engine.prompt_buckets:
        exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
        rec["prefill_replay_ms"][b] = cs.time_ms(lambda: exe(params, cache, padded, 0, b), 5)
    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    rec["prefill_kernels"] = replay_kernels(cs, lambda: exe(params, cache, padded, 0, b))

    m, N = cfg.mla, cfg.n_heads
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    B, S = engine.max_slots, 1
    shapes = {
        f"decode {name}": (randn(N, B, S, m.kv_lora_rank).permute(1, 2, 0, 3),
                           randn(B, S, N, m.qk_rope_head_dim), cache["ckv"][0],
                           cache["krope"][0], pos[:, None].clone(), pos + S)
        for name, pos in offsets.items()}
    shapes.update({
        f"prefill {b}": (randn(N, 1, b, m.kv_lora_rank).permute(1, 2, 0, 3),
                         randn(1, b, N, m.qk_rope_head_dim), randn(1, b, m.kv_lora_rank),
                         randn(1, b, m.qk_rope_head_dim),
                         torch.arange(b, device="cuda")[None], torch.full((1,), b,
                                                                          device="cuda")),
    })
    with torch.no_grad():
        rec["plain_stages_ms"] = {name: plain_stages(cs, *args, scale)
                                  for name, args in shapes.items()}
    OUT.mkdir(exist_ok=True)
    (OUT / f"mla_replays_{index}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", default="build/parent,.")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child is not None:
        child(Path(a.root).resolve(), a.child)
        return
    roots = [(HERE / r).resolve() for r in a.roots.split(",")]
    runs = []
    for i, k in enumerate(int(x) for x in a.order.split(",")):
        proc = subprocess.run([sys.executable, __file__, "--child", str(i), "--root",
                               str(roots[k])], cwd=HERE, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:])
            raise SystemExit(f"run {i} ({roots[k]}) failed: rc {proc.returncode}")
        rec = json.loads((OUT / f"mla_replays_{i}.json").read_text())
        runs.append(rec)
        pk = rec["prefill_kernels"]
        print(f"run {i} {roots[k].name or roots[k]}: {rec['device']} ({rec['nvidia_smi']}) | "
              + " | ".join(f"decode {n} (pos {d['pos']}) replay {d['replay_ms']:.5f} ms, "
                           f"kernels {d['kernels']['kernel_ms']:.5f} (B2 "
                           f"{d['kernels']['b2_ms']:.5f}, B6 {d['kernels']['b6_ms']:.5f} in "
                           f"{d['kernels']['b6_kernels']})" for n, d in rec["decode"].items())
              + " | prefill replays "
              + " / ".join(f"{v:.5f}" for v in rec["prefill_replay_ms"].values())
              + f" ms, bucket 512 kernels {pk['kernel_ms']:.5f} (B2 {pk['b2_ms']:.5f}, B6 "
              f"{pk['b6_ms']:.5f} in {pk['b6_kernels']}) | plain stages "
              + json.dumps({s: {n: round(v, 5) for n, v in st.items()}
                            for s, st in rec["plain_stages_ms"].items()}), flush=True)
        tops = [(f"decode {n}", d["kernels"]["top"]) for n, d in rec["decode"].items()]
        for name, top in tops + [("prefill", pk["top"])]:
            for ms, c, key in top[:6]:
                print(f"    {name} {ms:9.5f} ms x{c:<4d} {key}")


if __name__ == "__main__":
    main()
