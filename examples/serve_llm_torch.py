"""Multi-tenant serving example of the PyTorch port: async dispatch over
steps sealed as CUDA graphs.

    PYTHONPATH=src python examples/serve_llm_torch.py --requests 24
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --smoke \
        --archs stablelm-1.6b,phi4-mini-3.8b --fairness weighted --weights 3,1

The port of ``examples/serve_llm.py``, with the same flags plus
``--device`` (``cuda``, the default, or ``cpu``; no card with the default
raises) and ``--smoke`` (the architectures' smoke configs at float32; use
it on the CPU).  The full configs are served at bfloat16.  Weights are
random, drawn from a seeded ``torch.Generator`` on the serving device, so
every stepping mode serves the same tokens.

Prefill and decode are sealed once per (model, bucket) through the shared
``ScheduleCache``; the ``AsyncDispatcher`` steps each tenant on its own
daemon thread (``--stepping per-engine``, the default — decode overlaps
across models), multiplexes every tenant over a small fixed worker pool
(``--stepping pool --pool-size N`` — the many-tenant shape: thread count
stays at N no matter how many models register), or ships granted quanta
to per-device **worker processes** (``--stepping workers --devices N`` —
the multi-device shape: each process owns its device, engines, and
schedule cache, and a dying device fails only its own lanes) while
``submit`` returns futures immediately — the request loop is pure submission (the
inference-serving face of Nimble's ahead-of-time scheduling), and no
stepper ever captures (``builds_on_thread`` below stays 0).  ``--fairness`` picks
the policy: round-robin rotation, weighted fair queueing (``--weights``,
per arch; exact shares, serial decode), ``drr`` weighted deficit
round-robin (proportional shares that overlap across workers),
``lottery`` (probabilistic shares), or token-rate quotas (tokens per
wall-clock second).  ``--cache-budget-mb`` caps the reserved-arena bytes
the shared schedule cache may hold (LRU entries are evicted past it).

Mixed interactive + batch serving: ``--priority-classes 0,1`` assigns one
priority class per arch (lower = more important; any nonzero class turns
the fairness policy into per-class composition — class 0 preempts class 1
at quantum granularity, batch renewals simply stop while interactive work
is ready, in-flight steps always complete) and ``--latency-targets-ms
250,0`` gives classes latency targets (0 = best-effort): requests whose
deadlines are provably unmeetable are refused with ``AdmissionRejected``
on their futures instead of poisoning the tail.

    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --smoke \
        --archs stablelm-1.6b,phi4-mini-3.8b \
        --priority-classes 0,1 --latency-targets-ms 5000,0

Multi-process, multi-device: ``--stepping workers`` registers picklable
``ServingEngineSpec`` recipes instead of live engines — each worker
process builds its engines on its own CUDA device (round-robin lane
assignment, worker *i* on device ``i % device_count``; workers start with
``spawn``) and the parent keeps only the O(1) grant path.  On the CPU the
workers all serve the CPU:

    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --smoke \
        --archs stablelm-1.6b,phi4-mini-3.8b \
        --stepping workers --devices 2

Durable control plane: ``--journal serve.db`` appends every lane
registration and request lifecycle transition to a SQLite WAL journal
off the hot path.  If the journal already holds live lanes — the last
run crashed — the dispatcher **recovers first**: tenants re-register
from their journaled picklable specs, unfinished requests requeue in
their original admission order (work that was mid-step when the crash
landed is marked ``INTERRUPTED`` and replays from scratch), and their
futures are awaited alongside the new submissions.  Kill a run
mid-flight (Ctrl-Z, ``kill -9 %1``) and re-run the same command to
watch it:

    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --smoke \
        --requests 24 --journal /tmp/serve.db

Observability (``repro_torch.obs``): ``--trace-out trace.json`` records the
whole run with the span tracer and exports Chrome trace-event JSON —
open it at https://ui.perfetto.dev or chrome://tracing to see each
worker's step spans and one async track per request.  ``--metrics-dump
metrics.json`` (or ``.prom``) writes one unified registry snapshot —
dispatcher + fairness + arbiter + schedule-cache series — as JSON or
Prometheus text.
"""

import argparse
import json
import time

import numpy as np
import torch

import repro_torch.configs as C
import repro_torch.obs as obs
from repro_torch.dispatch import (
    AdmissionRejected,
    AsyncDispatcher,
    RequestJournal,
    ScheduleCache,
    WorkerPlane,
)
from repro_torch.serving import ServingEngineSpec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="stablelm-1.6b",
                    help="comma-separated model list (each becomes a tenant)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--bucketing", default="pow2:8:32",
                    help='"exact", "pow2[:MIN:MAX]", or e.g. "8,16,32"')
    ap.add_argument("--fairness", default="round_robin",
                    help='"round_robin", "weighted", "drr[:QUANTUM]", '
                         '"lottery[:SEED]", or "quota[:RATE[:BURST]]"')
    ap.add_argument("--weights", default="",
                    help="comma-separated per-arch weights (weighted/quota)")
    ap.add_argument("--priority-classes", default="",
                    help="comma-separated per-arch priority classes "
                         "(lower = more important; any nonzero class "
                         "composes the fairness policy per class)")
    ap.add_argument("--latency-targets-ms", default="",
                    help="comma-separated per-arch latency targets in ms "
                         "(0 = best-effort; targeted lanes get admission "
                         "control and deadline tracking)")
    ap.add_argument("--stepping", default="per-engine",
                    choices=("per-engine", "single", "pool", "workers"),
                    help="one stepper thread per model, one shared loop, "
                         "a fixed worker pool multiplexing all tenants, or "
                         "per-device worker processes")
    ap.add_argument("--pool-size", type=int, default=0,
                    help="worker count for --stepping pool "
                         "(0 = min(8, cpu_count))")
    ap.add_argument("--devices", type=int, default=0,
                    help="worker processes for --stepping workers, one per "
                         "device (0 = every CUDA device; 1 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="serve on the card (default) or on the CPU")
    ap.add_argument("--smoke", action="store_true",
                    help="the architectures' smoke configs, at float32")
    ap.add_argument("--max-concurrent-steps", type=int, default=0,
                    help="cap simultaneous engine steps (0 = no cap)")
    ap.add_argument("--cache-budget-mb", type=float, default=0.0,
                    help="byte budget for the shared schedule cache "
                         "(0 = entry-count LRU only)")
    ap.add_argument("--trace-out", default="",
                    help="record the run and export Chrome trace-event / "
                         "Perfetto JSON to this path")
    ap.add_argument("--metrics-dump", default="",
                    help="write one metrics-registry snapshot here "
                         "(.prom suffix: Prometheus text; else JSON)")
    ap.add_argument("--journal", default="",
                    help="SQLite WAL request journal (durable control "
                         "plane): lane registrations and request "
                         "lifecycle transitions append here off the hot "
                         "path; if the file already holds live lanes — "
                         "the last run crashed — recover them before "
                         "serving (tenants re-register from journaled "
                         "specs, unfinished requests replay)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu --smoke")
    dtype = "float32" if args.smoke else "bfloat16"

    tracer = obs.get_tracer()
    if args.trace_out:
        tracer.enable()

    spec = args.bucketing
    bucketing = (tuple(int(b) for b in spec.split(","))
                 if spec.replace(",", "").isdigit() else spec)
    archs = args.archs.split(",")
    weights = ([float(w) for w in args.weights.split(",")]
               if args.weights else [1.0] * len(archs))
    if len(weights) != len(archs):
        ap.error("--weights must list one weight per arch")
    classes = ([int(c) for c in args.priority_classes.split(",")]
               if args.priority_classes else [0] * len(archs))
    if len(classes) != len(archs):
        ap.error("--priority-classes must list one class per arch")
    targets = ([float(t) for t in args.latency_targets_ms.split(",")]
               if args.latency_targets_ms else [0.0] * len(archs))
    if len(targets) != len(archs):
        ap.error("--latency-targets-ms must list one target per arch")

    cache = ScheduleCache(
        capacity=64,
        byte_budget=(int(args.cache_budget_mb * 2**20)
                     if args.cache_budget_mb else None),
    )
    workers_mode = args.stepping == "workers"
    plane = None
    if workers_mode:
        # spawned worker processes (a forked child could not use a CUDA
        # context of this process), one per device
        n_devices = args.devices or (
            torch.cuda.device_count() if args.device == "cuda" else 1)
        plane = WorkerPlane(n_devices, device=args.device, start_method="spawn")
    journal = RequestJournal(args.journal) if args.journal else None
    dispatcher = AsyncDispatcher(
        max_pending=4 * args.requests,
        fairness=args.fairness,
        stepping=args.stepping,
        max_concurrent_steps=args.max_concurrent_steps or None,
        pool_size=args.pool_size or None,
        worker_plane=plane,
        journal=journal,
    )
    recovered = {}
    if journal is not None and journal.recover_state().lanes:
        # the journal holds live lanes: the last run crashed mid-flight.
        # Recover BEFORE registering or starting — lanes rebuild from
        # their journaled specs, unfinished requests requeue in admission
        # order, and their futures land in report["futures"] so this run
        # awaits the crashed run's work alongside its own.
        report = dispatcher.recover(journal)
        recovered = report["futures"]
        print(f"recovered from {args.journal}: "
              f"{len(report['lanes'])} lane(s) re-registered, "
              f"{report['requeued']} request(s) requeued "
              f"({report['interrupted']} interrupted mid-step, "
              f"{report['preempted']} un-granted)")

    t0 = time.perf_counter()
    cfgs = {}
    for arch, weight, cls, target in zip(archs, weights, classes, targets):
        cfg = C.get(arch, smoke=args.smoke)
        cfgs[arch] = cfg
        if arch in dispatcher.models:      # rebuilt by recovery above
            continue
        # the picklable recipe: in workers mode it IS the registration
        # (the assigned worker process builds and seals it on its own
        # device, in its own cache); in journaled in-process modes it
        # rides along as spec= so a restarted dispatcher can rebuild
        # this lane without us
        recipe = ServingEngineSpec(
            arch=arch, max_slots=args.slots, max_len=128,
            bucketing=bucketing, smoke=args.smoke, dtype=dtype,
            device=args.device,
        )
        if workers_mode:
            engine = recipe
        else:
            engine = recipe.build(0, schedule_cache=cache)
        dispatcher.register_model(
            arch, engine, weight=weight,
            priority_class=cls, latency_target_ms=target or None,
            spec=(recipe if journal is not None and not workers_mode
                  else None),
        )
    if workers_mode:
        print(f"sealing done in {time.perf_counter()-t0:.1f}s "
              f"(sealed inside {dispatcher.plane.n_workers} worker "
              f"process(es), one schedule cache per device)")
    else:
        print(f"sealing done in {time.perf_counter()-t0:.1f}s "
              f"({cache.stats.builds} steps sealed on {args.device}, "
              f"shared cache)")

    rng = np.random.default_rng(0)
    models = dispatcher.models
    t0 = time.perf_counter()
    futures = list(recovered.values())     # crashed run's work, replayed
    with dispatcher:                       # start() .. stop(drain=True)
        for i in range(args.requests):
            arch = models[i % len(models)]
            cfg = cfgs[arch]
            futures.append(dispatcher.submit(
                arch,
                rng.integers(0, cfg.vocab, int(rng.integers(4, 30))).astype(np.int64),
                max_new_tokens=args.max_new,
                tenant=f"tenant-{i % 3}",
            ))
        t_submitted = time.perf_counter() - t0
        done, refused = [], 0
        for f in futures:
            try:
                done.append(f.result(timeout=600))
            except AdmissionRejected:
                refused += 1               # typed backpressure, per future
        snap = dispatcher.snapshot()       # while steppers are still live
        if args.metrics_dump:
            # collected inside the with-block too: the arbiter series only
            # exists while the steppers are live
            registry = obs.MetricsRegistry()
            obs.register_dispatch(registry, dispatcher)
            obs.register_cache(registry, cache)
            if args.trace_out:
                obs.register_tracer(registry, tracer)
            text = (registry.to_prometheus()
                    if args.metrics_dump.endswith(".prom")
                    else registry.to_json(indent=2))
            with open(args.metrics_dump, "w") as f:
                f.write(text)
    wall = time.perf_counter() - t0
    print(f"served {len(done)} requests over {len(models)} model(s) "
          f"in {wall:.2f}s (submit loop itself: {t_submitted*1e3:.1f}ms — "
          f"the caller never hosted the serving loop)"
          + (f" [{len(recovered)} replayed from the crashed run]"
             if recovered else ""))
    print(f"throughput {snap['tokens_per_second']:,.0f} tok/s | "
          f"TTFT p50 {snap['ttft_ms']['p50']:.0f}ms | "
          f"e2e p99 {snap['e2e_ms']['p99']:.0f}ms | "
          f"stepping: {snap['async']['stepping']} "
          f"({snap['async']['steppers']} stepper(s)) | "
          f"builds on steppers: {snap['async']['builds_on_thread']}")
    if snap["async"]["arbiter"] is not None:
        arb = snap["async"]["arbiter"]
        print(f"arbiter: {arb['grants']} grants, "
              f"grant p95 {snap['grant_ms']['p95']:.2f}ms, "
              f"grant cpu p50 {snap['grant_cost_ms']['p50']*1e3:.0f}us, "
              f"{arb['wakeups_per_grant']:.2f} wakeups/grant "
              f"({arb['timed_grants']} served by the fallback tick)"
              + (f" | pool occupancy mean {snap['pool']['busy_mean']:.1f}"
                 f"/{snap['pool']['size']} (peak {snap['pool']['busy_peak']})"
                 if "pool" in snap else ""))
    for name, eng in snap.get("engines", {}).items():
        print(f"  engine[{name}]: {eng['steps']} steps, "
              f"step p50 {eng['step_ms']['p50']:.1f}ms "
              f"p99 {eng['step_ms']['p99']:.1f}ms, {eng['tokens']} tokens")
    if snap["async"].get("workers"):
        for w in snap["async"]["workers"]["workers"]:
            print(f"  worker[{w['worker']}] pid={w['pid']} "
                  f"device={w['device']} {w['status']}: "
                  f"lanes={','.join(w['lanes'])}, "
                  f"{w['stats'].get('steps', 0)} steps, "
                  f"{w['restarts']} restart(s)")
    print("fairness:", json.dumps(snap["fairness"], default=str))
    if "classes" in snap:
        for cls, c in sorted(snap["classes"].items()):
            print(f"  class[{cls}] {','.join(c['lanes'])}: "
                  f"e2e p99 {c['e2e_ms']['p99']:.0f}ms, "
                  f"grant p95 {c['grant_ms']['p95']:.2f}ms, "
                  f"{c['preemptions']} preemptions, {c['shed']} shed, "
                  f"{c['admission_rejected']} refused, "
                  f"deadline misses {c['deadline_miss']}/{c['deadline_total']}")
        if refused:
            print(f"admission refused {refused} request(s) "
                  f"(AdmissionRejected on their futures)")
    if not workers_mode:                   # workers own per-device caches
        cache_snap = cache.snapshot()
        print(f"schedule cache: "
              f"{json.dumps(cache.stats.as_dict(), indent=None)} "
              f"(arena {cache_snap['arena_bytes_total']} bytes, "
              f"budget {cache_snap['byte_budget']})")
    if done:
        sample = done[0]
        print(f"sample [{sample.model}]: prompt[{len(sample.prompt)}] -> "
              f"{sample.generated}")
    if args.trace_out:
        tracer.disable()
        # workers mode: merge the plane's collected worker spans (shutdown
        # drained each worker's final ring) — one process track per worker
        extra = (dispatcher.plane.trace_events() if workers_mode else None)
        trace = obs.write_chrome_trace(args.trace_out, tracer,
                                       extra_events=extra)
        errors = obs.validate_trace(trace)
        st = tracer.stats()
        print(f"trace: {len(trace['traceEvents'])} events -> "
              f"{args.trace_out} ({st['dropped']} dropped"
              + (f"; {len(extra)} worker-process spans merged" if extra
                 else "")
              + "; open it at https://ui.perfetto.dev or chrome://tracing)"
              + (f" — INVALID: {errors[:3]}" if errors else ""))
    if args.metrics_dump:
        print(f"metrics snapshot -> {args.metrics_dump}")
    if journal is not None:
        journal.sync(timeout=10.0)
        js = journal.stats()
        journal.close()
        print(f"journal: {js['records']} records in {js['commits']} "
              f"commit(s), {js['compactions']} compaction(s)"
              + (f", DEGRADED ({js['dropped_records']} dropped)"
                 if js["degraded"] else "")
              + f" -> {args.journal}")


if __name__ == "__main__":
    main()
