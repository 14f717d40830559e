"""Multi-pod dry run on the meta device: every architecture x input shape x
production mesh, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes      # all cases

The counterpart of the JAX package's ``launch/dryrun.py``, with its CLI.
For each case it builds the model (:func:`repro_torch.models.abstract_model`)
and the step's inputs (:func:`repro_torch.configs.shapes.input_specs`) on
the meta device, and for train shapes AdamW's float32 moments; gives each
leaf its logical axes (the parameters', the moments' the same,
``cache_axes(per_slot=False)`` for the decode cache, ``distributed.batch_axes``
for the batch, ``LONG_CONTEXT_OVERRIDES`` at ``long_500k``) and from them
its placement on the mesh (16x16 ``("data", "model")`` or 2x16x16 with
``"pod"``); then records

* the bytes of one device's share of the step's arguments, split as
  params, optimizer, cache and batch (the counterpart of XLA's
  ``memory_analysis().argument_size_in_bytes``: every sharded dimension
  divided by its mesh axes' size);
* the step's FLOPs: the train step (``make_train_step`` with
  ``cfg.remat``, as JAX lowers it), ``forward`` (prefill) or
  ``decode_step`` (decode) run once on the meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts matrix
  products and attention (not element-wise work), for the whole global
  batch;
* ``param_count`` and ``active_param_count``;
* the partitioned step, per mesh: in the case's process a fake process
  group of the mesh's size (no devices, no data moved) under a
  ``DeviceMesh``, the meta parameters, AdamW state, batch and cache
  placed on it as DTensors by their axes, and the step run once under
  ``launch.comm_analysis.CommCounter`` (:func:`count_step`), which gives
  one device's

  - ``collectives``: collective operand bytes and counts per kind (JAX
    records ``hlo_analysis.collective_bytes`` of the compiled HLO);
  - ``flops_per_device``: the products' FLOPs on its local shards;
  - ``bytes_accessed``: the bytes every op that is not a view reads and
    writes (JAX's ``cost_analysis()["bytes accessed"]``, but unfused: the
    port runs, and its CUDA graphs replay, one kernel an op);
  - ``memory.output_bytes``: the storages of the returned tensors the step
    made (an in-place AdamW update and cache write return their
    arguments, where JAX returns new trees);
  - ``memory.temp_bytes``: the peak of the bytes the step made while it
    ran, less the outputs', so that argument + temp + output bytes is its
    peak (XLA's ``temp_size_in_bytes``); ``memory.fits`` says whether that
    sum fits one H100's 80 GB.

  A kernel's plain version, which the meta tensors take
  (:func:`repro_torch.kernels.takes_plain`), counts as the one launch it
  stands for.  DTensor's dispatch costs the host about a millisecond an
  op, so the program is run at the depths 2P and 3P
  (``partitioned_layers``; P, from ``models.layer_period``, is 1 but for
  xLSTM, the hybrid and gemma2) and its numbers extrapolated to
  ``n_layers``: n(2P) + (L/P - 2)(n(3P) - n(2P)).  That is exact while
  every period of the stack partitions alike from the second on (the first
  can differ: its peak holds no earlier period's output; a test holds a
  4-layer run against it).  Every family must partition: a step that
  cannot fails its case, naming the op that stopped it.

Results go to ``experiments/dryrun_torch/*.json``; any failure exits 1.
JAX's ``--unroll`` has no counterpart: the port's layers are a Python
loop, every layer counted.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import re
import time
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as C
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, applicable, input_specs
from repro_torch.distributed import (LONG_CONTEXT_OVERRIDES, batch_axes, local_shape, pspec,
                                     shard_model, shard_tree, use_sharding_ctx, with_defaults)
from repro_torch.launch.comm_analysis import CommCounter, collective_bytes
from repro_torch.launch.mesh import DEVICE_MEMORY_BYTES, make_production_mesh
from repro_torch.models import abstract_model, cache_axes, decode_step, forward, layer_period
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
GROUPS = ("params", "optimizer", "cache", "batch")
# the families whose step must partition: every one
MUST_PARTITION = ("dense", "vlm", "moe", "audio", "hybrid", "ssm")


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


def build_case(arch: str | Any, shape_name: str | InputShape, mesh=None, rules=None, *,
               remat: bool = True) -> Case:
    """The case of ``arch`` (a name, or a config) at ``shape_name`` (a name,
    or a shape); with a ``mesh``, its parameters, AdamW state, batch and
    cache placed on it as DTensors by their axes under ``DEFAULT_RULES +
    rules``, and its step run under that sharding context.  A train step
    recomputes each layer in its backward (``cfg.remat``, as JAX's dry run
    lowers it) unless ``remat`` is False, which keeps the config's."""
    t0 = time.perf_counter()
    cfg = C.get(arch) if isinstance(arch, str) else arch
    kind, specs = input_specs(cfg, shape_name)
    model, axes = abstract_model(cfg)
    if mesh is not None:
        shard_model(model, axes, mesh, rules)

    def place(tree, tree_axes):
        return tree if mesh is None else shard_tree(tree, tree_axes, mesh, rules)

    params = [(name, p, axes[name]) for name, p in model.named_parameters()]
    leaves = {group: [] for group in GROUPS}
    leaves["params"] = params
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=cfg.remat or remat)
        train_step = make_train_step(cfg, lr=1e-4, mesh=mesh, rules=rules)
        opt = adamw_init({name: p for name, p, _ in params})
        leaves["optimizer"] = [("step", opt.step, "")] + [
            (f"{moment}.{name}", getattr(opt, moment)[name], ax)
            for moment in ("mu", "nu") for name, _, ax in params]
        batch = place(specs["batch"], batch_axes(specs["batch"]))
        leaves["batch"] = list(_flatten(batch, batch_axes(batch)))

        def step():
            return train_step(model, opt, batch)
    elif kind == "prefill":
        batch = place(specs["batch"], batch_axes(specs["batch"]))
        leaves["batch"] = list(_flatten(batch, batch_axes(batch)))

        def step():
            with torch.no_grad(), use_sharding_ctx(mesh, rules):
                return forward(model, batch, cfg)
    else:
        c_axes = cache_axes(cfg, per_slot=False)
        cache = place(specs["cache"], c_axes)
        tokens = place(specs["tokens"], "batch seq")
        leaves["cache"] = list(_flatten(cache, c_axes))
        leaves["batch"] = [("tokens", tokens, "batch seq")]

        def step():
            with torch.no_grad(), use_sharding_ctx(mesh, rules):
                return decode_step(model, cache, tokens, cfg)
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
    Mutating and aliasing ops (in-place writes, views, and an op found to
    return its input's storage though its schema says nothing of it) always
    run, and so does an op whose output is not on the meta device (a factory op making
    a CPU tensor has data, and no recorded layout stands for it)."""

    def __init__(self) -> None:
        super().__init__()
        self._fresh: dict = {}
        self._seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # its local ops come back here
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
            if _shares_storage(out, (args, kwargs)):
                self._fresh[func] = False      # a view by another name (_unsafe_view)
                return out
            with contextlib.suppress(_Uncached):
                self._seen[key] = _layouts(out)
            return out
        return _empties(rec)


def _shares_storage(out, inputs) -> bool:
    """Some tensor of ``out`` shares a storage with one of ``inputs``."""
    ins = {id(t.untyped_storage()) for t in pytree.tree_leaves(inputs)
           if isinstance(t, torch.Tensor)}
    return any(id(t.untyped_storage()) in ins for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


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


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> Iterator[Any]:
    """A ``DeviceMesh`` of ``shape`` over a fake process group of as many
    ranks, this process rank 0: DTensor partitions on it and its
    collectives move nothing.  The group is destroyed on exit."""
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _op_of(error: BaseException) -> str:
    """The aten op an error names (DTensor's missing sharding rule), else
    the op DTensor was dispatching when it raised (the innermost
    ``op_call`` of its frames) with the error, else the error alone."""
    found = re.search(r"aten\.[\w.]+", str(error))
    if found:
        return found.group(0)
    op, tb = None, error.__traceback__
    while tb is not None:
        op = tb.tb_frame.f_locals.get("op_call", op)
        tb = tb.tb_next
    what = f"{type(error).__name__}: {str(error)[:300]}"
    return f"{op} ({what})" if isinstance(op, torch._ops.OpOverload) else what


def _at_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (an audio encoder in proportion)."""
    enc = cfg.n_enc_layers * layers // cfg.n_layers
    if enc * cfg.n_layers != cfg.n_enc_layers * layers:
        raise ValueError(f"{cfg.n_enc_layers} encoder layers do not scale with {layers} "
                         f"of {cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=enc)


def _extrapolate(a, b, periods: int):
    """``a + periods * (b - a)`` through nested dicts of numbers."""
    if isinstance(a, dict):
        return {k: _extrapolate(a[k], b[k], periods) for k in a}
    return a + periods * (b - a)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def count_step(step) -> dict:
    """One device's share of ``step()`` (meta tensors, DTensors on a fake
    mesh) under :class:`CommCounter` and :class:`MetaShapeCache`:
    ``collectives``, ``flops_per_device``, ``bytes_accessed``,
    ``output_bytes`` (the storages of the returned tensors that the step
    made: none of an argument, which the port's in-place AdamW and cache
    writes return) and ``temp_bytes`` (the peak of the bytes the step made,
    less the outputs': argument + temp + output bytes is the step's peak)."""
    with MetaShapeCache(), CommCounter() as counter:
        out = step()
    storages = {id(st): st.nbytes() for st in (
        _local(t).untyped_storage() for t in pytree.tree_leaves(out)
        if isinstance(t, torch.Tensor) and counter.made(_local(t)))}
    output = sum(storages.values())
    del out
    return {"collectives": collective_bytes(counter.records), "flops_per_device": counter.flops,
            "bytes_accessed": counter.bytes_accessed, "temp_bytes": counter.peak_bytes - output,
            "output_bytes": output}


def _partition_once(cfg, shape_name, mesh, rules) -> dict:
    return count_step(build_case(cfg, shape_name, mesh, rules).step)


def as_run(shape: tuple[int, ...], names: tuple[str, ...], rules=None):
    """The mesh the partitioned pass runs on: ``("pod", "data")`` as one
    ``data`` axis of their product when every rule that names ``pod``
    names exactly ``("pod", "data")`` (the default rules and the
    long-context overrides do).  A dimension sharded over both is cut pod
    by pod, then data by data, as one axis of the product cuts it, and
    each reduction over both is one collective, as in JAX; DTensor plans
    three-dimensional meshes far more slowly (minutes a case)."""
    if "pod" not in names:
        return shape, names
    entries = [e for e in with_defaults(rules).values()
               if isinstance(e, (tuple, str)) and "pod" in (e if isinstance(e, tuple) else (e,))]
    pod, data = names.index("pod"), names.index("data")
    if data != pod + 1 or any(e != ("pod", "data") for e in entries):
        return shape, names
    merged = shape[:pod] + (shape[pod] * shape[data],) + shape[data + 1:]
    return merged, names[:pod] + names[data:]


def partitioned(cfg, shape_name, shape: tuple[int, ...], names: tuple[str, ...],
                rules=None, **build) -> dict:
    """One device's share of the case's step on a fake mesh of ``shape``
    (axis ``names``): ``{"partitioned": True, **count_step(...),
    "partitioned_layers": depths run, "partition_s": ...}``, run at depths
    2P and 3P and extrapolated to ``cfg.n_layers`` (or at full depth when
    that is at most 3P).  ``build`` goes to :func:`build_case`.  A step
    that cannot partition raises, naming the op that stopped it."""
    t0 = time.perf_counter()
    period, layers = layer_period(cfg), cfg.n_layers
    depths = (layers,) if layers <= 3 * period else (2 * period, 3 * period)
    shape, names = as_run(shape, names, rules)
    try:
        with fake_mesh(shape, names) as mesh:
            runs = [count_step(build_case(_at_depth(cfg, d), shape_name, mesh, rules,
                                          **build).step) for d in depths]
    except Exception as e:
        raise RuntimeError(f"{cfg.name} x {getattr(shape_name, 'name', shape_name)} does not "
                           f"partition on {'x'.join(map(str, shape))}: {_op_of(e)}") from e
    record = runs[0] if len(runs) == 1 else _extrapolate(*runs, layers // period - 2)
    return {"partitioned": True, **record, "partitioned_layers": list(depths),
            "partitioned_mesh": "x".join(map(str, shape)),
            "partition_s": round(time.perf_counter() - t0, 3)}


def run_case(arch: str, shape_name: str, *, meshes=(False,)) -> list[dict]:
    """The records of one arch x shape, one per mesh (``multi_pod`` flags):
    the case is built and its step counted once, the bytes and the
    partitioned step per mesh."""
    case = build_case(arch, shape_name)
    t0 = time.perf_counter()
    flops = step_flops(case)
    flops_s = time.perf_counter() - t0
    cfg = C.get(arch)
    rules = dict(LONG_CONTEXT_OVERRIDES) if shape_name == "long_500k" else None
    records = []
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        part = partitioned(cfg, shape_name, mesh.shape, mesh.mesh_dim_names, rules)
        memory = {f"{group}_bytes": device_bytes(case.leaves[group], mesh, rules)
                  for group in GROUPS}
        memory["argument_bytes"] = sum(memory.values())
        memory["temp_bytes"] = part.pop("temp_bytes")
        memory["output_bytes"] = part.pop("output_bytes")
        memory["device_memory_bytes"] = DEVICE_MEMORY_BYTES
        memory["fits"] = (memory["argument_bytes"] + memory["temp_bytes"]
                          + memory["output_bytes"]) <= DEVICE_MEMORY_BYTES
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
            **part,
        })
    return records


def partition_line(r: dict) -> str:
    """The partitioned pass of a record, for its line."""
    c, m = r["collectives"], r["memory"]
    kinds = " ".join(f"{k}={c['counts'][k]}/{c['bytes_per_kind'][k] / 2**20:.1f}MiB"
                     for k in c["counts"] if c["counts"][k])
    return (f"per device: flops={r['flops_per_device']:.3e} accessed="
            f"{r['bytes_accessed'] / 2**30:.3f} GiB temp={m['temp_bytes'] / 2**30:.3f} GiB "
            f"output={m['output_bytes'] / 2**30:.3f} GiB collectives "
            f"{c['total_bytes'] / 2**30:.3f} GiB [{kinds}] ({r['partition_s']}s)")


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
                      f"flops={r['flops']:.3e} ({r['flops_s']}s) {partition_line(r)}",
                      flush=True)
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
