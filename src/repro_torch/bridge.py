"""Carry JAX parameters into the port.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so parity tests make the weights once, in JAX, and move them over::

    np_tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(np_tree, cfg, device="cpu")
    branchy = branchy_params_from_jax(np_tree, device="cpu")

This module imports no JAX: it takes the parameter tree as nested dicts of
numpy arrays, with the JAX package's leading layer axis on the stacked
``layers`` (and audio's ``encoder`` and ``decoder``), or xLSTM's ``layers``
as a list of per-layer dicts.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.models.transformer import Transformer

# the subtrees that JAX stacks on a leading layer axis
STACKED = ("layers", "encoder", "decoder")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    # torch.tensor copies: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16: reinterpret bits
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(a)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


@torch.no_grad()
def params_from_jax(np_tree: Mapping, cfg, *, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Transformer:
    """A :class:`Transformer` holding the JAX parameters ``np_tree``.

    The stacked subtrees (``layers``, ``encoder``, ``decoder``) are
    unstacked along their leading axis into ``layers[i]`` and so on (the MoE
    leaves ``moe.*`` and ``moe.shared.*``, MLA's ``attn.*`` and Mamba2's
    ``mamba.*`` among them); a list (xLSTM's ``layers``) maps element by
    element; every other leaf (``projector``, ``shared_attn``,
    ``frontend_proj``, ``enc_final_norm`` among them) maps by name.  Each
    value is cast to the module's dtype for that parameter (``dtype``,
    default ``cfg.dtype``; the float32 leaves stay float32).  Raises
    ``ValueError`` if the names or shapes of the two trees differ."""
    model = Transformer(cfg, device=device, dtype=dtype)
    wanted = dict(model.named_parameters())
    given: dict[str, np.ndarray] = {}
    for key, sub in np_tree.items():
        if isinstance(sub, (list, tuple)):
            for i, layer in enumerate(sub):
                given.update(_flatten(layer, f"{key}.{i}."))
        elif key in STACKED:
            for name, leaf in _flatten(sub):
                for i in range(leaf.shape[0]):
                    given[f"{key}.{i}.{name}"] = leaf[i]
        else:
            given.update(_flatten({key: sub}))
    if set(given) != set(wanted):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(wanted) - set(given))}, "
            f"unexpected {sorted(set(given) - set(wanted))}"
        )
    for name, t in wanted.items():
        src = _to_tensor(np.asarray(given[name]))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != {tuple(t.shape)}")
        t.copy_(src.to(t.dtype))
    return model


def branchy_params_from_jax(np_tree: Mapping, *, device="cuda") -> dict[str, torch.Tensor]:
    """The branchy cells' parameters (``models/branchy.py``): a flat dict of
    numpy arrays becomes a dict of tensors of the same names, dtypes and
    shapes on ``device``."""
    return {name: _to_tensor(np.asarray(a)).to(device) for name, a in np_tree.items()}
