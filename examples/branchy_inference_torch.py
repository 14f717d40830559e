"""Multi-stream scheduling walk-through on a branchy (NAS-cell) graph, in
the PyTorch port.

    PYTHONPATH=src python examples/branchy_inference_torch.py               # on the card
    PYTHONPATH=src python examples/branchy_inference_torch.py --device cpu --dot cell.dot

The port of ``examples/branchy_inference.py``: the full Algorithm 1
pipeline on a traced graph (MEG, bipartite matching, stream chains, sync
plan), then single-stream against multi-stream replay.  ``--dot PATH``
writes the schedule as DOT (paste into graphviz).  Times are CUDA events
on the card and the host clock on the CPU.
"""

import argparse

import torch

from repro_torch.configs.branchy_cell import darts_like
from repro_torch.core import Nimble, assign_streams, minimum_equivalent_graph, trace_to_taskgraph
from repro_torch.models.branchy import branchy_forward, example_input, init_branchy

from quickstart_torch import per_call_us


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dot", default=None, help="write the stream-coloured schedule here")
    args = ap.parse_args()
    device = torch.device(args.device)

    cfg = darts_like()
    params = init_branchy(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    x = example_input(cfg, device=device)

    def fn(params, x):
        return branchy_forward(params, x, cfg)

    traced = trace_to_taskgraph(fn, params, x)
    g = traced.graph
    meg = minimum_equivalent_graph(g)
    sa = assign_streams(g)

    print(f"cell: {cfg.n_branches} branches x {cfg.n_cells} cells")
    print(f"task graph: |V|={g.num_tasks} |E|={g.num_edges} -> MEG |E'|={meg.num_edges}")
    print(f"max matching |M|={sa.matching_size} -> streams={sa.num_streams}, "
          f"syncs=|E'|-|M|={sa.num_syncs}")
    print(f"degree of logical concurrency: {g.max_logical_concurrency()}")
    longest = max(sa.chains(), key=len)
    print(f"longest stream chain: {len(longest)} tasks "
          f"({' -> '.join(g.tasks[t].name for t in longest[:6])} ...)")

    single = Nimble(fn, params, x, multi_stream=False)
    multi = Nimble(fn, params, x)
    packed = Nimble(fn, params, x, pack_streams=True)
    ref = single(params, x).clone()
    torch.testing.assert_close(multi(params, x), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(packed(params, x), ref, rtol=1e-4, atol=1e-4)
    t_s = per_call_us(single, (params, x), 30, device)
    t_m = per_call_us(multi, (params, x), 30, device)
    t_p = per_call_us(packed, (params, x), 30, device)
    print(f"\nsingle-stream AoT: {t_s:7.1f} us | multi-stream: {t_m:7.1f} us "
          f"({t_s / t_m:.2f}x) | packed (stream_pack): {t_p:7.1f} us ({t_s / t_p:.2f}x)")

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(g.to_dot(streams=dict(enumerate(sa.stream_of))))
        print(f"stream-coloured DOT -> {args.dot}")


if __name__ == "__main__":
    main()
