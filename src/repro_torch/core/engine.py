"""Execution engines: the run-time-scheduled baseline vs AoT replay.

``EagerInterpreter`` is our stand-in for the base framework's run loop
(paper §2, Fig. 1): for every task, at *every* execution, it

  1. pops the next ready operator (operator emission),
  2. checks input types/shapes,
  3. infers output types/shapes,
  4. dispatches the kernel (table lookup on (operator, dtype, shape-rank)),
  5. allocates output buffers through a caching-allocator model,
  6. prepares kernel arguments, and only then
  7. submits the task (calls the aten operator).

Steps 1–6 are the *scheduling overhead* the paper measures; step 7 is the
task itself.  ``TaskSchedule.replay`` skips 1–6 entirely.  On the card,
step 7 enqueues the kernel and returns, as PyTorch's eager mode does, so
``DispatchProfile.submit_s`` is launch time there, not kernel time.

The interpreter is intentionally honest: it executes the same aten operators
as the sealed schedule (tests assert allclose), so engine comparisons are
apples-to-apples, exactly like the paper's "scheduling-minimized PyTorch"
experiment (Fig. 2b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import fx
from torch.utils import _pytree as pytree

from .trace import TracedGraph, out_vals, read, trace_to_taskgraph


@dataclasses.dataclass
class DispatchProfile:
    """Where the time went, per execution (fig. 2a analogue)."""

    total_s: float = 0.0
    schedule_s: float = 0.0    # steps 1-6
    submit_s: float = 0.0      # step 7 (enqueue on the card; the kernel on the CPU)
    num_tasks: int = 0

    @property
    def overhead_fraction(self) -> float:
        return self.schedule_s / self.total_s if self.total_s else 0.0


class _CachingAllocator:
    """Models the framework's cached GPU memory pool (free-list per size
    class, as in PyTorch's CUDACachingAllocator).  We do the bookkeeping the
    real allocator does — size-class rounding, free-list probe, split — and
    charge its (CPU) cost to scheduling, without owning real device memory.
    """

    def __init__(self) -> None:
        self.free_lists: dict[int, list[int]] = {}
        self.next_addr = 0
        self.live: dict[int, int] = {}  # addr -> size class

    @staticmethod
    def _size_class(nbytes: int) -> int:
        if nbytes <= 512:
            return 512
        # round to next power-of-two-ish 512 multiple (PyTorch: 512B granularity)
        return (nbytes + 511) // 512 * 512

    def alloc(self, nbytes: int) -> int:
        sc = self._size_class(nbytes)
        fl = self.free_lists.get(sc)
        if fl:
            addr = fl.pop()
        else:
            addr = self.next_addr
            self.next_addr += sc
        self.live[addr] = sc
        return addr

    def free(self, addr: int) -> None:
        sc = self.live.pop(addr)
        self.free_lists.setdefault(sc, []).append(addr)


class EagerInterpreter:
    """Op-by-op run-time scheduling over a traced task list."""

    def __init__(self, fn: Callable, *example_args: Any) -> None:
        self.traced: TracedGraph = trace_to_taskgraph(fn, *example_args)
        self._dispatch: dict[tuple, Any] = {}
        self._prepare_liveness()

    def _prepare_liveness(self) -> None:
        tasks = self.traced.node_of_task

        def source(n):
            # a getitem node reads its producer's value
            while n.op == "call_function" and n not in self._index:
                n = n.args[0]
            return n

        self._index = {n: i for i, n in enumerate(tasks)}
        self.last_use: dict[fx.Node, int] = {}
        for ei, node in enumerate(tasks):
            for inp in node.all_input_nodes:
                self.last_use[source(inp)] = ei
        for out in self.traced.output_nodes:
            if isinstance(out, fx.Node):
                self.last_use[source(out)] = len(tasks)

    def run(self, *args: Any, profile: DispatchProfile | None = None) -> Any:
        """One full execution with run-time scheduling per task."""
        traced = self.traced
        allocator = _CachingAllocator()
        addr_of: dict[fx.Node, list[int]] = {}

        t_start = time.perf_counter()
        sched_s = 0.0
        submit_s = 0.0
        env = traced.input_env(traced.flatten_args(args))

        for ei, node in enumerate(traced.node_of_task):
            s0 = time.perf_counter()
            # (2) input type/shape check
            for inp in node.all_input_nodes:
                want, got = inp.meta.get("val"), read(env, inp)
                if isinstance(want, torch.Tensor) and tuple(got.shape) != tuple(want.shape):
                    raise TypeError(
                        f"shape mismatch for {node.target}: "
                        f"{tuple(got.shape)} vs {tuple(want.shape)}"
                    )
            # (3) output shape inference (recompute, as run-time schedulers do)
            outs = [v for v in out_vals(node) if isinstance(v, torch.Tensor)]
            # (4) kernel dispatch: registry lookup
            _ = self._dispatch.setdefault(
                (str(node.target), str(outs[0].dtype) if outs else "",
                 outs[0].dim() if outs else 0),
                node.target,
            )
            # (5) output allocation through the caching allocator model
            addrs = [allocator.alloc(max(v.numel() * v.element_size(), 1)) for v in outs]
            # (6) argument preparation
            call_args, call_kwargs = fx.node.map_arg(
                (node.args, node.kwargs), lambda n: read(env, n))
            s1 = time.perf_counter()
            sched_s += s1 - s0

            # (7) submit: op-by-op execution of the kernel
            with torch.no_grad():
                env[node] = node.target(*call_args, **call_kwargs)
            s2 = time.perf_counter()
            submit_s += s2 - s1

            addr_of[node] = addrs
            # free dead buffers back to the pool (allocator traffic)
            s3 = time.perf_counter()
            for n in list(addr_of):
                if self.last_use.get(n, -1) <= ei:
                    for a in addr_of.pop(n):
                        allocator.free(a)
            sched_s += time.perf_counter() - s3

        out = traced.outputs(env)
        total = time.perf_counter() - t_start
        if profile is not None:
            profile.total_s += total
            profile.schedule_s += sched_s
            profile.submit_s += submit_s
            profile.num_tasks += len(traced.node_of_task)
        return traced.unflatten_out(out)

    __call__ = run


def _sync_if_cuda(tree: Any) -> None:
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in pytree.tree_leaves(tree)):
        torch.cuda.synchronize()


def compare_engines(
    fn: Callable,
    *args: Any,
    iters: int = 20,
    warmup: int = 3,
    multi_stream: bool = True,
    pack_streams: bool = False,
) -> dict[str, float]:
    """Time eager run-time scheduling vs AoT replay on identical inputs.

    Returns microseconds per call for each engine (host clock, each run
    ending in a synchronisation on the card) plus the speedup — the repo's
    Fig. 2b / Fig. 7 measurement primitive.
    """
    from .aot import Nimble

    eager = EagerInterpreter(fn, *args)
    nimble = Nimble(fn, *args, multi_stream=multi_stream, pack_streams=pack_streams)

    # correctness gate: identical numerics
    ref = eager.run(*args)
    got = nimble(*args)
    _assert_trees_close(ref, got)

    def per_call_us(run) -> float:
        for _ in range(warmup):
            run(*args)
        _sync_if_cuda(args)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(*args)
        _sync_if_cuda(args)
        return (time.perf_counter() - t0) / iters * 1e6

    eager_us = per_call_us(eager.run)
    aot_us = per_call_us(nimble)
    return {
        "eager_us": eager_us,
        "aot_us": aot_us,
        "speedup": eager_us / aot_us if aot_us else float("inf"),
        "num_tasks": eager.traced.graph.num_tasks,
        "num_streams": nimble.stats.num_streams,
        "num_syncs": nimble.stats.num_syncs,
        "concurrency_degree": nimble.stats.degree_of_concurrency,
    }


def _assert_trees_close(a, b, rtol=2e-3, atol=2e-3):
    la = pytree.tree_leaves(a)
    lb = pytree.tree_leaves(b)
    assert len(la) == len(lb), (len(la), len(lb))
    for x, y in zip(la, lb):
        np.testing.assert_allclose(
            x.detach().double().cpu().numpy(),
            y.detach().double().cpu().numpy(),
            rtol=rtol,
            atol=atol,
        )
