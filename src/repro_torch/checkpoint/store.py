"""Checkpointing: flat-key npz + json manifest, the JAX package's format.

``arrays.npz`` holds one array per leaf under its ``/``-joined pytree path
(``torch.utils._pytree``), ``manifest.json`` the step, metadata and each
array's shape and dtype.  bfloat16, which numpy lacks, is stored as its
raw bytes (``uint8`` with a trailing axis of 2) and named in the manifest,
as the JAX package stores it, so either package restores the other's
checkpoints.  A module in a tree stands for the dict of its named
parameters (JAX's stacked layer axis is not rebuilt; carry a JAX tree into
a model with :mod:`repro_torch.bridge`).

Sharded leaves (DTensors) are saved whole: every process gathers each
one (call :func:`save_checkpoint` on all of them) and process 0 writes, so
the files are those a single-process run writes and restore into a
single-process model; restored into sharded parameters, each process
keeps its own shard.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.distributed import local_part

# numpy dtypes by name, and bfloat16, which numpy lacks
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
                 "int8": torch.int8, "bool": torch.bool}


def _as_tree(tree: Any) -> Any:
    """Modules as dicts of their named parameters, anywhere in the tree."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _as_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_as_tree(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _path_token(p) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _flatten(tree: Any) -> tuple[list[tuple[str, Any]], Any]:
    """(``/``-joined key, leaf) of every leaf, and the tree's spec."""
    leaves, spec = pytree.tree_flatten_with_path(_as_tree(tree))
    return [("/".join(_path_token(p) for p in path), leaf) for path, leaf in leaves], spec


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """The array to store and the dtype name for the manifest."""
    if isinstance(leaf, torch.Tensor):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.uint8).numpy()
            return raw.reshape(tuple(t.shape) + (2,)), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str | pathlib.Path, tree: Any, *, step: int = 0,
                    metadata: Optional[dict] = None) -> None:
    path = pathlib.Path(path)
    arrays = {}
    manifest = {"step": step, "metadata": metadata or {}, "arrays": {}}
    for k, v in _flatten(tree)[0]:
        arr, dtype = _to_numpy(v)
        arrays[k] = arr
        shape = list(arr.shape[:-1]) if dtype == "bfloat16" else list(arr.shape)
        manifest["arrays"][k] = {"shape": shape, "dtype": dtype}
    if dist.is_initialized() and dist.get_rank() != 0:
        return                          # process 0 writes what every process gathered
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "arrays.npz", **arrays)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _restored(arr: np.ndarray, meta: dict) -> torch.Tensor:
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":
        if arr.dtype != np.uint8:
            raise ValueError(f"bfloat16 stored as {arr.dtype}, not raw bytes")
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16).reshape(shape)
    if meta["dtype"] not in _TORCH_DTYPES:
        raise ValueError(f"dtype {meta['dtype']} is not restorable")
    return torch.from_numpy(np.array(arr)).to(_TORCH_DTYPES[meta["dtype"]]).reshape(shape)


def restore_checkpoint(path: str | pathlib.Path, like: Any,
                       device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a module as the dict of its
    named parameters): each parameter, a module's among them, is filled in
    place; every other leaf (a tensor or an array) becomes a new tensor on
    ``device``, or on the leaf's own device.  Raises ``ValueError`` when
    the keys or the shapes differ."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves, spec = _flatten(like)
    out = []
    with np.load(path / "arrays.npz") as data:
        keys = {k for k, _ in leaves}
        missing, extra = keys - set(data.files), set(data.files) - keys
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")
        for k, ref in leaves:
            t = _restored(data[k], manifest["arrays"][k])
            if tuple(t.shape) != tuple(np.shape(ref)):
                raise ValueError(f"{k}: shape {tuple(t.shape)} != {tuple(np.shape(ref))}")
            if isinstance(ref, nn.Parameter):
                with torch.no_grad():
                    if isinstance(ref, DTensor):
                        ref.to_local().copy_(local_part(t, ref.device_mesh, ref.placements))
                    else:
                        ref.copy_(t)
                out.append(ref)
            else:
                own = ref.device if isinstance(ref, torch.Tensor) else "cpu"
                out.append(t.to(device if device is not None else own))
    return pytree.tree_unflatten(out, spec), manifest
