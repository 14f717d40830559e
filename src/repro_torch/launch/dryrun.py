"""Multi-pod dry run on the meta device: every architecture x input shape x
production mesh, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes      # all cases

The counterpart of the JAX package's ``launch/dryrun.py``, with its CLI.
For each case it builds the model (:func:`repro_torch.models.abstract_model`)
and the step's inputs (:func:`repro_torch.configs.shapes.input_specs`) on
the meta device, and for train shapes AdamW's float32 moments; gives each
leaf its logical axes (the parameters', the moments' the same,
``cache_axes(per_slot=False)`` for the decode cache, :func:`_batch_axes`
for the batch, ``LONG_CONTEXT_OVERRIDES`` at ``long_500k``) and from them
its placement on the mesh (16x16 ``("data", "model")`` or 2x16x16 with
``"pod"``); then records

* the bytes of one device's share of the step's arguments, split as
  params, optimizer, cache and batch (the counterpart of XLA's
  ``memory_analysis().argument_size_in_bytes``: every sharded dimension
  divided by its mesh axes' size), and whether they fit one H100's memory;
* the step's FLOPs: the train step (``make_train_step`` with
  ``cfg.remat``, as JAX lowers it), ``forward`` (prefill) or
  ``decode_step`` (decode) run once on the meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts matrix
  products and attention (not element-wise work), for the whole global
  batch;
* ``param_count`` and ``active_param_count``.

Results go to ``experiments/dryrun_torch/*.json``; any failure exits 1.
The kernel wrappers take their plain versions on meta tensors
(:func:`repro_torch.kernels.takes_plain`), which only propagate shapes.

What has no torch analogue yet, and is not recorded: XLA's temp bytes
(the activations' peak; a meta run allocates nothing to measure), the
per-device FLOPs of the partitioned program (the port partitions nothing
yet: the FLOPs are the global step's), and collective bytes (JAX's
``hlo_analysis`` reads them from HLO text, which the port never produces;
they come with sharded execution, which counts a sharded DTensor step's
collectives).  JAX's ``--unroll`` has no counterpart: the port's layers
are a Python loop, every layer counted.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as C
from repro_torch.configs.shapes import INPUT_SHAPES, applicable, input_specs
from repro_torch.distributed import LONG_CONTEXT_OVERRIDES, local_shape, pspec
from repro_torch.launch.mesh import DEVICE_MEMORY_BYTES, make_production_mesh
from repro_torch.models import abstract_model, cache_axes, decode_step, forward
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
GROUPS = ("params", "optimizer", "cache", "batch")


def _batch_axes(batch: dict) -> dict:
    axes = {}
    for k, v in batch.items():
        if k in ("tokens", "labels"):
            axes[k] = "batch seq"
        elif k in ("vision_embeds", "frames"):
            axes[k] = "batch _ _"
        else:
            axes[k] = " ".join(["_"] * v.dim())
    return axes


def _flatten(tree: Any, axes: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor, str]]:
    """``(name, tensor, axes string)`` of every leaf of a tree of dicts and
    lists and the matching tree of axes strings."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, axes[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, axes[i], f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree, axes


@dataclasses.dataclass
class Case:
    """One arch x shape on the meta device: its leaves by group, each with
    its axes, and the step to count."""

    kind: str
    leaves: dict[str, list[tuple[str, torch.Tensor, str]]]
    step: Any
    build_s: float


def build_case(arch: str, shape_name: str) -> Case:
    t0 = time.perf_counter()
    cfg = C.get(arch)
    kind, specs = input_specs(cfg, shape_name)
    model, axes = abstract_model(cfg)
    params = [(name, p, axes[name]) for name, p in model.named_parameters()]
    leaves = {group: [] for group in GROUPS}
    leaves["params"] = params
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
        train_step = make_train_step(cfg, lr=1e-4)
        opt = adamw_init({name: p for name, p, _ in params})
        leaves["optimizer"] = [("step", opt.step, "")] + [
            (f"{moment}.{name}", getattr(opt, moment)[name], ax)
            for moment in ("mu", "nu") for name, _, ax in params]
        batch = specs["batch"]
        leaves["batch"] = list(_flatten(batch, _batch_axes(batch)))

        def step():
            train_step(model, opt, batch)
    elif kind == "prefill":
        batch = specs["batch"]
        leaves["batch"] = list(_flatten(batch, _batch_axes(batch)))

        def step():
            with torch.no_grad():
                forward(model, batch, cfg)
    else:
        cache, tokens = specs["cache"], specs["tokens"]
        leaves["cache"] = list(_flatten(cache, cache_axes(cfg, per_slot=False)))
        leaves["batch"] = [("tokens", tokens, "batch seq")]

        def step():
            with torch.no_grad():
                decode_step(model, cache, tokens, cfg)
    return Case(kind, leaves, step, time.perf_counter() - t0)


def device_bytes(leaves, mesh, rules=None) -> int:
    """Bytes of one device's share of ``leaves`` (``(name, tensor, axes)``)
    laid out on ``mesh`` by their axes."""
    return sum(math.prod(local_shape(t.shape, pspec(t.shape, ax, mesh, rules), mesh))
               * t.element_size() for _, t, ax in leaves)


class _Uncached(Exception):
    pass


def _key(x):
    """The part of an argument that a meta op's output depends on."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncached              # real data (a CPU scalar, say)
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(e) for e in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    hash(x)
    return x


class MetaShapeCache(TorchDispatchMode):
    """Memoises meta-device ops: on the meta device an op's output shapes,
    strides and dtypes are a function of its inputs' and its other
    arguments alone, so an op seen before with the same ones returns fresh
    empty meta tensors of the recorded layout instead of running torch's
    meta kernel again (many are Python decompositions, 0.1-0.7 ms each;
    the sLSTM steps through 32768 positions with ~20 of them a step).
    Mutating and aliasing ops (in-place writes, views) always run, and so
    does an op whose output is not on the meta device (a factory op making
    a CPU tensor has data, and no recorded layout stands for it)."""

    def __init__(self) -> None:
        super().__init__()
        self._fresh: dict = {}
        self._seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh = self._fresh.get(func)
        if fresh is None:
            schema = func._schema
            fresh = self._fresh[func] = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
        if not fresh:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except (_Uncached, TypeError):
            return func(*args, **kwargs)
        rec = self._seen.get(key)
        if rec is None:
            out = func(*args, **kwargs)
            with contextlib.suppress(_Uncached):
                self._seen[key] = _layouts(out)
            return out
        return _empties(rec)


def _layouts(out):
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            raise _Uncached              # made off the meta device: it has data
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return ("s", type(out), [_layouts(o) for o in out])
    return ("v", out)


def _empties(rec):
    if rec[0] == "t":
        return torch.empty_strided(rec[1], rec[2], dtype=rec[3], device="meta")
    if rec[0] == "s":
        return rec[1](_empties(r) for r in rec[2])
    return rec[1]


def step_flops(case: Case) -> int:
    """The FLOPs ``FlopCounterMode`` counts in one run of the case's step
    (over :class:`MetaShapeCache`, which sees each op after the counter)."""
    with MetaShapeCache(), FlopCounterMode(display=False) as counter:
        case.step()
    return int(counter.get_total_flops())


def run_case(arch: str, shape_name: str, *, meshes=(False,)) -> list[dict]:
    """The records of one arch x shape, one per mesh (``multi_pod`` flags):
    the case is built and its step counted once, the bytes per mesh."""
    case = build_case(arch, shape_name)
    t0 = time.perf_counter()
    flops = step_flops(case)
    flops_s = time.perf_counter() - t0
    cfg = C.get(arch)
    rules = dict(LONG_CONTEXT_OVERRIDES) if shape_name == "long_500k" else None
    records = []
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        memory = {f"{group}_bytes": device_bytes(case.leaves[group], mesh, rules)
                  for group in GROUPS}
        memory["argument_bytes"] = sum(memory.values())
        memory["device_memory_bytes"] = DEVICE_MEMORY_BYTES
        memory["fits"] = memory["argument_bytes"] <= DEVICE_MEMORY_BYTES
        records.append({
            "arch": arch,
            "shape": shape_name,
            "kind": case.kind,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "devices": mesh.size,
            "build_s": round(case.build_s, 3),
            "flops_s": round(flops_s, 3),
            "flops": flops,
            "memory": memory,
            "params": cfg.param_count,
            "active_params": cfg.active_param_count,
        })
    return records


def run(archs, shapes, meshes, out_dir: pathlib.Path | None = None) -> list[tuple[str, str]]:
    """Every applicable arch x shape on ``meshes``: prints one line a case,
    writes its JSON (under :data:`OUT_DIR` by default), returns the
    failures as ``(tag, error)``."""
    out_dir = out_dir or OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        cfg = C.get(arch)
        for shape in shapes:
            if not applicable(cfg, shape):
                print(f"SKIP  {arch} x {shape} (long_500k runs on sub-quadratic archs only)")
                continue
            try:
                records = run_case(arch, shape, meshes=meshes)
            except Exception as e:  # noqa: BLE001 - report and continue
                tag = f"{arch}_{shape}"
                failures.append((tag, str(e)[:500]))
                print(f"FAIL  {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
                continue
            for r in records:
                tag = f"{arch}_{shape}_{r['mesh']}"
                (out_dir / f"{tag}.json").write_text(json.dumps(r, indent=1))
                m = r["memory"]
                print(f"OK    {tag}: args/device={m['argument_bytes'] / 2**30:.3f} GiB "
                      f"(params {m['params_bytes'] / 2**30:.3f}, optimizer "
                      f"{m['optimizer_bytes'] / 2**30:.3f}, cache {m['cache_bytes'] / 2**30:.3f}, "
                      f"batch {m['batch_bytes'] / 2**30:.4f}) fits={m['fits']} "
                      f"flops={r['flops']:.3e} ({r['flops_s']}s)", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    archs = C.all_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    failures = run(archs, shapes, meshes)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
