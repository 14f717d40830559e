"""Serving engine: continuous batching over sealed prefill/decode steps.

The port of the JAX package's ``serving/engine.py``, with the same contract:
per-request state lives in batch slots of a shared KV cache, each slot
decodes at its own offset (``kv_cache["pos"]`` is per-slot), finished
requests are replaced without disturbing neighbours, and prompts are padded
to a bucket chosen by a ``repro_torch.dispatch.bucketing`` policy.

The seal is Nimble's own: on CUDA each step is captured once as a
``torch.cuda.CUDAGraph`` over static buffers (the token buffer, ``slot`` and
``true_len``), and every later call copies its inputs into them and replays
the graph.  Captures go through a ``ScheduleCache``.  The graph replays
against the addresses it was captured over, so the KV cache is updated
**in place** (the JAX steps return a new cache instead), and on CUDA the
schedule key names the engine's weights and KV cache: engines share a
sealed graph only if they share those buffers.  On the CPU a step is sealed
to its eager callable, which takes weights and cache as arguments and is
shared across engines as in JAX.  A capture that fails raises; nothing
falls back to eager on the card.

Many threads may drive many engines (the ``AsyncDispatcher``): every seal
holds :data:`repro_torch.core.capture.CAPTURE_LOCK` exclusively and every
step's device sections hold it shared, so a lane that registers (or
re-seals after an eviction) never captures while another lane replays.
Each seal and each step runs with the engine's device current on the
calling thread (CUDA's current device belongs to the thread, and a
dispatcher's stepper steps engines it did not build).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import capture as _capture
from repro_torch.core.aot import ScheduleKey
from repro_torch.dispatch.bucketing import BucketingPolicy, make_policy
from repro_torch.dispatch.cache import ScheduleCache
from repro_torch.dispatch.errors import DrainTimeoutError
from repro_torch.models.transformer import cache_names, decode_step, init_cache, prefill
from repro_torch.obs.tracer import get_tracer


@dataclasses.dataclass
class Request:
    """One generation request: prompt in, tokens out, engine-stamped
    timestamps (``t_submit``/``t_first``/``t_done``) for latency metrics.

    ``truncated`` is set when the engine stopped the request early because
    its context window filled (``prompt + generated`` reached ``max_len``)
    — the caller got fewer than ``max_new_tokens`` tokens and this flag is
    the signal saying why.  ``error`` is set (with ``done``) when the
    request was failed rather than served — an unservable prompt reaching
    admission, or a retire racing a direct submit — so no request ever
    silently vanishes.  ``deadline`` (0.0 — none) is stamped by the
    dispatcher's SLO plane at admission when the lane carries a latency
    target: submit time plus target, on the SLO policy's clock — the value
    overload shedding compares against.  ``state`` is the explicit
    lifecycle state (:class:`repro_torch.dispatch.lifecycle.RequestState`)
    stamped by the dispatcher's lifecycle tracker; requests submitted
    straight to an engine keep the empty string and are exempt from
    lifecycle enforcement (and from journaling)."""

    rid: int
    prompt: np.ndarray                 # (P,) int
    max_new_tokens: int = 16
    tenant: str = ""
    model: str = ""
    deadline: float = 0.0
    on_complete: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False            # finished early: context window full
    error: Optional[str] = None        # failed (not served): why
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    state: str = ""


@dataclasses.dataclass
class EngineStats:
    """Per-engine counters: seals (CUDA-graph captures on the card, eager
    seals on the CPU), graph replays, steps, token and wall-time totals
    (prefill vs decode split).  Times include waiting for the device."""

    prefill_compiles: int = 0
    decode_compiles: int = 0
    prefill_replays: int = 0     # CUDA-graph replays of a prefill bucket
    decode_replays: int = 0      # CUDA-graph replays of the decode step
    steps: int = 0
    tokens_out: int = 0          # decode-produced tokens only
    prefill_tokens: int = 0      # first tokens, produced by prefill
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def decode_tok_per_s(self) -> float:
        """Decode-only token throughput (tokens out / decode seconds)."""
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was asked for, but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ServingEngine:
    """Sealed-step batched serving for the dense, MoE and vlm architectures
    (vlm prompts are text only, as in JAX)."""

    def __init__(
        self,
        cfg,
        params,
        *,
        max_slots: int = 4,
        max_len: int = 256,
        prompt_buckets: tuple[int, ...] = (32, 128),
        bucketing: Any = None,
        schedule_cache: Optional[ScheduleCache] = None,
        warmup: bool = True,
        device: Any = "cuda",
        tracer: Any = None,
    ) -> None:
        if cfg.family in ("hybrid", "ssm"):
            raise NotImplementedError(
                "slot-replacement serving needs re-settable recurrent state; "
                "use batch decode directly for SSM/hybrid archs"
            )
        if cfg.family == "audio":
            # JAX's engine takes audio but fails in its prefill: a cache made
            # with memory_len=0 passes its (B, 0, D) memory leaf unsliced
            raise NotImplementedError(
                "the engine serves no encoder-decoder model (no memory per "
                "slot): run encode_memory, then init_cache(memory_len=T) with "
                "cache['memory'] set, then batch decode_step"
            )
        self.cfg = cfg
        self.device = _resolve_device(device)
        elsewhere = sorted({str(t.device) for t in params.parameters()} - {str(self.device)})
        if elsewhere:
            raise ValueError(
                f"the engine runs on {self.device} but its weights are on "
                f"{elsewhere}: move them first (params.to(device))"
            )
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.bucketing: BucketingPolicy = make_policy(
            bucketing if bucketing is not None else prompt_buckets
        )
        # explicit None-check: an empty ScheduleCache is falsy (__len__ == 0)
        self.schedule_cache = (
            ScheduleCache(capacity=32) if schedule_cache is None else schedule_cache
        )
        self.stats = EngineStats()
        self.tracer = tracer if tracer is not None else get_tracer()

        # KV cache, updated in place by every step for the engine's lifetime
        self.kv_cache = init_cache(cfg, max_slots, max_len, device=self.device)
        self._graphs = self.device.type == "cuda"
        # sealed-step identity beyond arg shapes.  A CUDA graph is bound to
        # the buffers it was captured over, so on the card the key names
        # this engine's weights and KV cache (the cached entry holds both,
        # so their ids cannot be recycled while it lives).
        self._key_options = (
            ("cfg", repr(cfg)),
            ("max_len", max_len),
            ("max_slots", max_slots),
            ("device", str(self.device)),
        )
        if self._graphs:
            self._key_options += (("buffers", (id(params), id(self.kv_cache))),)
        self._param_tree = dict(params.named_parameters())
        # per-engine memo of bucket -> ScheduleKey (only the key: sealed
        # steps stay owned by the shared cache and its LRU)
        self._prefill_keys: "OrderedDict[int, ScheduleKey]" = OrderedDict()
        self._prefill_key_cap = 64
        self._decode = self._get_decode_exec()
        if warmup:
            for b in self._warm_buckets():
                self._get_prefill_exec(b)

        self.slots: list[Optional[Request]] = [None] * max_slots
        self.queue: list[Request] = []
        self._next_tok = np.zeros((max_slots, 1), np.int64)
        # single-stepper guard: exactly one thread may drive step() at a
        # time; a second stepper is a loud error, not corrupted KV state
        self._step_mu = threading.Lock()
        self._retired = False
        self._submit_hook: Optional[Callable[[], None]] = None

    def retire(self) -> None:
        """Refuse all further submissions, drop the per-engine key memo and
        fail (never drop) every request still queued.  Idempotent."""
        self._retired = True
        stranded, self.queue = list(self.queue), []
        self._prefill_keys.clear()
        for req in stranded:
            self._fail_request(req, "engine retired with request queued")

    def _fail_request(self, req: Request, why: str) -> None:
        """Complete ``req`` as failed: ``done`` + ``error`` set, terminal
        timestamp stamped, ``on_complete`` fired (no locks held)."""
        req.error = why
        req.done = True
        req.t_done = time.perf_counter()
        cb = req.on_complete
        if cb is not None:
            cb(req.model, req)

    def set_submit_hook(self, hook: Optional[Callable[[], None]]) -> None:
        """Install (or clear, with ``None``) the hook fired after every
        :meth:`submit`.  It must be fast and must not call back into the
        engine."""
        self._submit_hook = hook

    # -- sealed steps through the schedule cache ---------------------------
    _EXEC_ARENA_FLOOR = 4096     # conservative floor: never report ~free

    def _exec_arena_bytes(self, *extra_shapes: tuple) -> int:
        """Reserved-memory estimate for one sealed step, from buffer shapes:
        the full KV cache (the dominant term) plus ``(shape, dtype)`` pairs
        for per-step buffers (e.g. a prefill's padded token buffer)."""
        kv = getattr(self, "_kv_arena_bytes", None)
        if kv is None:
            kv = self._kv_arena_bytes = sum(
                t.numel() * t.element_size() for t in self.kv_cache.values()
            )
        total = kv
        for shape, dtype in extra_shapes:
            total += math.prod(shape) * dtype.itemsize
        return max(self._EXEC_ARENA_FLOOR, total)

    def _warm_buckets(self) -> tuple[int, ...]:
        static = self.bucketing.static_buckets()
        if static is None:
            return ()
        return tuple(b for b in static if b <= self.max_len)

    @property
    def prompt_buckets(self) -> tuple[int, ...]:
        """Bucket family currently pre-sealable (exact policies: empty)."""
        return self._warm_buckets()

    def _spec(self, *shape) -> torch.Tensor:
        """Data-less stand-in for a token buffer (a ``meta`` tensor)."""
        return torch.empty(shape, dtype=torch.long, device="meta")

    def _get_decode_exec(self):
        key = ScheduleKey.from_call(
            decode_step,
            (self._param_tree, self.kv_cache, self._spec(self.max_slots, 1)),
            self._key_options,
            fn_id=f"serving.decode/{self.cfg.name}",
        )

        def build():
            exe = self._seal(self._decode_impl, np.zeros((self.max_slots, 1), np.int64))
            self.stats.decode_compiles += 1
            return exe

        return self.schedule_cache.get_or_build(
            key, build,
            arena_bytes=self._exec_arena_bytes(((self.max_slots, 1), torch.long)),
        )

    def _prefill_key(self, bucket: int) -> ScheduleKey:
        key = self._prefill_keys.get(bucket)
        if key is not None:
            self._prefill_keys.move_to_end(bucket)
            return key
        key = ScheduleKey.from_call(
            prefill,
            (self._param_tree, self._spec(1, bucket), self.kv_cache),
            self._key_options,
            fn_id=f"serving.prefill/{self.cfg.name}",
        )
        self._prefill_keys[bucket] = key
        while len(self._prefill_keys) > self._prefill_key_cap:
            self._prefill_keys.popitem(last=False)
        return key

    def _get_prefill_exec(self, bucket: int):
        key = self._prefill_key(bucket)

        def build():
            # example inputs: token 0 into slot 0 with true_len 1
            exe = self._seal(self._prefill_dyn, np.zeros((1, bucket), np.int64), 0, 1)
            self.stats.prefill_compiles += 1
            return exe

        return self.schedule_cache.get_or_build(
            key, build,
            arena_bytes=self._exec_arena_bytes(((1, bucket), torch.long)),
        )

    def _seal(self, fn, *example):
        """Seal ``fn(params, cache, *inputs)`` for inputs shaped like
        ``example`` (int64 arrays or Python ints).  Returns
        ``exe(params, cache, *inputs)``, where an input is a tensor or an
        int.

        CPU: the eager callable.  CUDA: one warm-up on a side stream, over a
        scratch KV cache so no live slot is touched, then one capture over
        static input buffers and the engine's own cache.  Either way the
        seal holds the capture lock exclusively, with the engine's device
        current (module docstring)."""
        with _capture.CAPTURE_LOCK.capturing(), self.device_scope():
            return self._seal_now(fn, *example)

    def device_scope(self):
        """``torch.cuda.device`` of the engine's device on CUDA, else a
        no-op: the context every seal and step of this engine runs in."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _seal_now(self, fn, *example):
        dev = self.device
        if not self._graphs:
            def run_eager(params, cache, *args):
                with torch.no_grad():
                    return fn(params, cache, *(torch.as_tensor(a, device=dev) for a in args))
            return run_eager

        bound_params, bound_cache = self.params, self.kv_cache
        static = [torch.as_tensor(a, dtype=torch.long).to(dev) for a in example]
        scratch = {k: torch.zeros_like(v) for k, v in bound_cache.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            fn(bound_params, scratch, *static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
            graph, capture_error_mode=_capture.CAPTURE_ERROR_MODE
        ):
            out = fn(bound_params, bound_cache, *static)

        def run_graph(params, cache, *args):
            if params is not bound_params or cache is not bound_cache:
                raise RuntimeError(
                    "a CUDA graph replays only over the weights and KV cache "
                    "it was captured with"
                )
            for buf, a in zip(static, args):
                if isinstance(a, torch.Tensor):
                    buf.copy_(a)
                else:
                    buf.fill_(a)
            graph.replay()
            return out

        return run_graph

    # -- sealed step bodies ------------------------------------------------
    def _decode_impl(self, params, cache, tokens):
        logits, _ = decode_step(params, cache, tokens, self.cfg)
        return torch.argmax(logits[:, :, : self.cfg.vocab], dim=-1)

    def _prefill_dyn(self, params, cache, tokens, slot, true_len):
        """Prefill one request (padded to a bucket) into cache slot ``slot``:
        the prompt pass runs on an empty cache, its keys/values (or MLA's
        latents) land at
        offsets ``[0, P)`` of the slot and ``pos[slot] = true_len``, all in
        place.  ``slot`` and ``true_len`` are 0-dim device tensors, so one
        captured graph serves every slot and prompt length of the bucket."""
        cfg = self.cfg
        logits, new = prefill(params, tokens, cfg)
        # next token from the true last prompt position (pre-pad)
        last = logits[0].index_select(0, (true_len - 1).reshape(1))[0, : cfg.vocab]
        nxt = torch.argmax(last)
        P = tokens.shape[1]
        s = slot.reshape(1)
        # k/v, or MLA's ckv/krope: every leaf but pos, in prefill's order
        for name, t in zip(cache_names(cfg), new):
            cache[name].narrow(2, 0, P).index_copy_(1, s, t.to(cache[name].dtype))
        cache["pos"].index_copy_(0, s, true_len.reshape(1))
        return nxt

    def compose_key(self) -> tuple:
        """Batched-decode compatibility key: the sealed step's identity
        beyond shapes (``_key_options``), the bucketing policy, and the
        weights' object identity."""
        return (self._key_options, repr(self.bucketing), id(self.params))

    # -- request flow --------------------------------------------------------
    def validate_request(self, req: Request) -> None:
        """Reject requests this engine can never serve (and everything,
        once retired)."""
        if self._retired:
            raise RuntimeError("engine is retired; it no longer serves")
        self._bucket(len(req.prompt))          # ValueError if unservable

    def submit(self, req: Request) -> None:
        """Enqueue ``req`` for admission on a later :meth:`step` (stamps
        ``t_submit`` unless already stamped), then fires the submit hook."""
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.queue.append(req)
        hook = self._submit_hook
        if hook is not None:
            hook()

    def free_slots(self) -> int:
        """Seats available right now, clamped at 0."""
        return max(0, sum(1 for s in self.slots if s is None) - len(self.queue))

    @property
    def idle(self) -> bool:
        """True when no request is queued and every batch slot is free."""
        return not self.queue and all(s is None for s in self.slots)

    def _bucket(self, plen: int) -> int:
        b = self.bucketing.bucket(plen)
        if b > self.max_len:
            raise ValueError(
                f"prompt bucket {b} exceeds engine max_len {self.max_len}"
            )
        return b

    def _finish(self, req: Request, slot: int) -> None:
        req.done = True
        req.t_done = time.perf_counter()
        self.slots[slot] = None
        # reset the slot's write offset for the next occupant
        with _capture.CAPTURE_LOCK.replaying():
            self.kv_cache["pos"][slot] = 0

    def _admit(self) -> list[Request]:
        finished: list[Request] = []
        for slot in range(self.max_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            # validate BEFORE popping: an unservable directly-submitted
            # prompt is failed and returned as finished
            req = self.queue[0]
            plen = len(req.prompt)
            try:
                b = self._bucket(plen)
            except ValueError as exc:
                self.queue.pop(0)
                self._fail_request(req, f"unservable prompt: {exc}")
                finished.append(req)
                continue
            self.queue.pop(0)
            exe = self._get_prefill_exec(b)    # schedule-cache hit when warm
            padded = np.zeros((1, b), np.int64)
            padded[0, :plen] = req.prompt
            t0 = time.perf_counter()
            with _capture.CAPTURE_LOCK.replaying():
                nxt = int(exe(self.params, self.kv_cache, torch.from_numpy(padded), slot, plen))
            dt = time.perf_counter() - t0
            if self._graphs:
                self.stats.prefill_replays += 1
            self.stats.prefill_s += dt
            if self.tracer.enabled:
                self.tracer.complete(
                    "prefill", t0, dt, cat="engine", rid=req.rid,
                    args={"bucket": b},
                )
            req.t_first = time.perf_counter()
            req.generated.append(nxt)
            self.stats.prefill_tokens += 1
            if len(req.generated) >= req.max_new_tokens:
                # e.g. a 1-token request: done at prefill, never seats
                self._finish(req, slot)
                finished.append(req)
                continue
            self._next_tok[slot, 0] = nxt
            self.slots[slot] = req
        return finished

    def step(self) -> list[Request]:
        """One engine iteration: admit + one decode step for all live slots.
        Returns every request that finished during this step."""
        if not self._step_mu.acquire(blocking=False):
            raise RuntimeError(
                "ServingEngine.step() entered concurrently: the engine is "
                "single-stepper; drive it from one thread"
            )
        try:
            with self.device_scope():
                return self._step_locked()
        finally:
            self._step_mu.release()

    def _step_locked(self) -> list[Request]:
        finished = self._admit()
        live = [s for s in range(self.max_slots) if self.slots[s] is not None]
        if not live:
            return finished
        t0 = time.perf_counter()
        with _capture.CAPTURE_LOCK.replaying():
            nxt = self._decode(self.params, self.kv_cache, torch.from_numpy(self._next_tok))
            nxt_np = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        if self._graphs:
            self.stats.decode_replays += 1
        self.stats.decode_s += dt
        if self.tracer.enabled:
            self.tracer.complete(
                "decode", t0, dt, cat="engine", args={"live": len(live)}
            )
        self.stats.steps += 1
        for s in live:
            req = self.slots[s]
            req.generated.append(int(nxt_np[s, 0]))
            self._next_tok[s, 0] = nxt_np[s, 0]
            self.stats.tokens_out += 1
            pos_full = len(req.prompt) + len(req.generated)
            if len(req.generated) >= req.max_new_tokens or pos_full >= self.max_len - 1:
                if len(req.generated) < req.max_new_tokens:
                    # context window full before max_new_tokens: say so
                    req.truncated = True
                self._finish(req, s)
                finished.append(req)
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Step until queue and slots are empty; raises
        :class:`~repro_torch.dispatch.errors.DrainTimeoutError` if
        ``max_steps`` pass with requests still in flight."""
        finished: list[Request] = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if self.idle:
                return finished
        if self.idle:
            return finished
        raise DrainTimeoutError(
            f"engine drain exhausted {max_steps} steps with "
            f"{len(self.queue) + sum(s is not None for s in self.slots)} "
            f"requests still in flight"
        )
