"""Quickstart of the PyTorch port: wrap a model in Nimble and see the gain.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port of ``examples/quickstart.py``: ``model = Nimble(model)`` and
everything else is automatic: task-graph capture, stream assignment
(Algorithm 1), memory planning, and sealing into one replayable executable
(one CUDA graph over Algorithm 1's CUDA streams on the card; a plain
callable on the CPU).  Times are CUDA events on the card and the host
clock on the CPU.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import EagerInterpreter, JitPerOpEngine, Nimble


# A branchy model: parallel feature extractors joined by a sum, the
# structure where Nimble's multi-stream scheduling shines (paper Table 1).
def model(params, x):
    h = torch.tanh(x @ params["stem"])
    branches = [torch.tanh(h @ params[f"b{i}"]) for i in range(8)]
    out = branches[0]
    for b in branches[1:]:
        out = out + b
    return out @ params["head"]


def per_call_us(fn, args, n: int, device: torch.device) -> float:
    """Mean microseconds per call over ``n`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    rng = np.random.default_rng(0)
    width = 128

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(device)

    params = {"stem": randn(width, width, scale=0.05), "head": randn(width, 16, scale=0.05)}
    for i in range(8):
        params[f"b{i}"] = randn(width, width, scale=0.05)
    x = randn(32, width)

    # --- engines -----------------------------------------------------------
    eager = EagerInterpreter(model, params, x)          # run-time scheduling
    jit = JitPerOpEngine(model, params, x)              # ops resolved ahead, scheduled per call
    nimble = Nimble(model, params, x, multi_stream=False)    # AoT schedule, sealed
    nimble_ms = Nimble(model, params, x)                # + Algorithm 1's streams

    st = nimble_ms.stats
    print(f"task graph: {st.num_tasks} tasks | degree of concurrency "
          f"{st.degree_of_concurrency} | {st.num_streams} streams | {st.num_syncs} syncs "
          f"(= |E'| - |M|, Theorem 3)")
    print(f"planned arena: {st.arena_bytes / 1024:.0f} KiB (reuse x{st.arena_reuse_factor:.1f})")

    ref = eager.run(params, x)
    for name, eng in (("jit", jit), ("AoT", nimble), ("AoT multi-stream", nimble_ms)):
        torch.testing.assert_close(eng(params, x), ref, rtol=1e-5, atol=1e-5,
                                   msg=f"{name} differs from eager")
    print("numerics: eager == jit per op == AoT == AoT multi-stream")

    t_e = per_call_us(eager.run, (params, x), 10, device)
    t_j = per_call_us(jit.run, (params, x), 10, device)
    t_a = per_call_us(nimble, (params, x), 50, device)
    t_m = per_call_us(nimble_ms, (params, x), 50, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"on {where}:")
    print(f"eager (run-time scheduling): {t_e:9.1f} us/call")
    print(f"jit per op (TorchScript)   : {t_j:9.1f} us/call  ({t_e / t_j:.1f}x)")
    print(f"Nimble AoT  (single-stream): {t_a:9.1f} us/call  ({t_e / t_a:.1f}x)")
    print(f"Nimble AoT  (multi-stream) : {t_m:9.1f} us/call  ({t_e / t_m:.1f}x)")


if __name__ == "__main__":
    main()
