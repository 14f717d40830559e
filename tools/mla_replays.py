#!/usr/bin/env python3
"""DeepSeek-V2's served decode and prefill replays on one card, with the
device time of MLA's plain absorbed attention by stage, for two checkouts
in turns.

    python3 tools/mla_replays.py [--roots build/parent,.] [--order 0,1,1,0]
                                 [--kernels [--variants]]

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

With ``--kernels`` each child times B6 alone instead, from its checkout's
``latent_attention.cu``, at the three shapes phase 3c times (the served
decode, decode_32k's share, prefill bucket 512; ``chip_smoke.LATENT_TIMED``,
inputs from ``chip_smoke._latent_inputs``): in a CUDA graph, with the plan,
ptxas's registers, spills and serialization notes
(``chip_smoke.latent_registers``); at the served decode also the attention
kernel and ``latent_combine`` apart (torch.profiler over 20 calls).  With
``--variants`` as well, the same for two copies of that source edited as
``VARIANTS`` says: the products removed, so the loads alone are left; the
cache's loads removed, so the products and the softmax are left.  The
edits are written for the two-warpgroup kernel: the run fails on a source
where an edit's text does not occur exactly once.  It writes
``chiprun_out/mla_kernels_<i>.json``.

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
# Timing variants of the two-warpgroup bf16 kernel as text edits of its
# source, (OLD, NEW) each, every OLD exactly once in it.
VARIANTS = {
    "no_products": [("wgmma_ss<64>(s, make_desc(", "if (0) wgmma_ss<64>(s, make_desc("),
                    ("wgmma_rs<64>(acc[c], pa[kk],", "if (0) wgmma_rs<64>(acc[c], pa[kk],"),
                    ("wgmma_n64_mn(acc[c], make_desc(p_box",
                     "if (0) wgmma_n64_mn(acc[c], make_desc(p_box"),
                    ("wgmma_rs_n256(acc, pa[kk],", "if (0) wgmma_rs_n256(acc, pa[kk],"),
                    ("wgmma_n256_mn(acc, make_desc(p_box",
                     "if (0) wgmma_n256_mn(acc, make_desc(p_box")],
    "no_loads": [("mbar_expect_tx(bar, n * BOX_BYTES);", "mbar_arrive(bar);"),
                 ("if (c < boxes) tma_load3(", "if (0) tma_load3("),
                 ("if (rope) tma_load3(", "if (0) tma_load3(")],
}


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


def variant_sources(source: Path, into: Path) -> dict:
    """An edited copy of ``source`` for each of ``VARIANTS``, each beside a
    copy of the header it includes, at the same relative path.  Raises
    ``SystemExit`` where an edit's OLD text does not occur exactly once."""
    text = source.read_text()
    header = source.parents[2] / "flash_attention" / "csrc" / "hopper.cuh"
    out = {}
    for name, edits in VARIANTS.items():
        new = text
        for old, rep in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{source}: variant {name}'s edit {old!r} occurs "
                                 f"{text.count(old)} times, not once")
            new = new.replace(old, rep)
        copy = into / name / "latent_attention" / "csrc" / f"latent_attention_{name}.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(new)
        shared = into / name / "flash_attention" / "csrc" / header.name
        shared.parent.mkdir(parents=True, exist_ok=True)
        shared.write_text(header.read_text())
        out[name] = copy
    return out


def kernel_child(root: Path, index: int, variants: bool) -> None:
    """B6 alone at phase 3c's timed shapes, and its variants: see the
    module's docstring."""
    sys.path[:0] = [str(root / "src"), str(HERE)]
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.latent_attention import latent_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {"kernel": b6.SOURCE}
    if variants:
        sources.update(variant_sources(b6.SOURCE, HERE / "build" / "mla_kernels" / str(index)))
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources.values()))
    rec = dict(root=str(root), device=torch.cuda.get_device_name(0), nvidia_smi=cs.nvidia_smi(),
               ptxas={}, ms={}, plans={})
    cases = {name: cs.LATENT_CASES[i] for name, i in
             zip(("served_decode", "decode_32k", "prefill_512"), cs.LATENT_TIMED)}
    inputs = {}
    for name, (label, B, S, T, N, R, Rr, dname, kvv0d, prompt) in cases.items():
        *ten, scale = cs._latent_inputs(B, S, T, N, R, Rr, dname, kvv0d, prompt, seed=600 + T,
                                        full=True)
        inputs[name] = (ten, scale)
        rec["plans"][name] = cs.latent_plan_text(b6.launch_for(*ten[:3]), B, S, N)
    with torch.no_grad():
        for variant, source in sources.items():
            b6.SOURCE, b6._lib = source, None
            b6._ready_devices.clear()
            rec["ptxas"][variant] = {k: v for k, v in
                                     cs.latent_registers(build.build_log(source)).items()
                                     if k.startswith("latent_attention_kernel")}
            rec["ms"][variant] = {
                name: cs.graph_ms(lambda ten=ten, scale=scale: latent_attention(*ten, scale=scale),
                                  10, 20)
                for name, (ten, scale) in inputs.items()}
        b6.SOURCE, b6._lib = sources["kernel"], None
        b6._ready_devices.clear()
        ten, scale = inputs["served_decode"]

        def twenty():
            for _ in range(20):
                out = latent_attention(*ten, scale=scale)
            return out

        rec["served_decode_kernels_us"] = {
            name: us / count for us, count, name in cs.by_kernel(cs.kernels_in_one(twenty))}
    OUT.mkdir(exist_ok=True)
    (OUT / f"mla_kernels_{index}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", default="build/parent,.")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--kernels", action="store_true",
                    help="time B6 alone instead of the replays")
    ap.add_argument("--variants", action="store_true",
                    help="with --kernels, also the loads alone and the products alone")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child is not None:
        if a.kernels:
            kernel_child(Path(a.root).resolve(), a.child, a.variants)
        else:
            child(Path(a.root).resolve(), a.child)
        return
    roots = [(HERE / r).resolve() for r in a.roots.split(",")]
    runs = []
    for i, k in enumerate(int(x) for x in a.order.split(",")):
        proc = subprocess.run([sys.executable, __file__, "--child", str(i), "--root",
                               str(roots[k])] + ["--kernels"] * a.kernels
                              + ["--variants"] * a.variants, cwd=HERE,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:])
            raise SystemExit(f"run {i} ({roots[k]}) failed: rc {proc.returncode}")
        if a.kernels:
            rec = json.loads((OUT / f"mla_kernels_{i}.json").read_text())
            print(f"run {i} {roots[k].name or roots[k]}: {rec['device']} ({rec['nvidia_smi']}) | "
                  f"plans {rec['plans']}", flush=True)
            for variant, ms in rec["ms"].items():
                print(f"    {variant:12s} " + " | ".join(f"{n} {v:.5f} ms" for n, v in ms.items())
                      + f" | ptxas {rec['ptxas'][variant]}", flush=True)
            print(f"    served decode by kernel (us a call): "
                  f"{rec['served_decode_kernels_us']}", flush=True)
            continue
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
