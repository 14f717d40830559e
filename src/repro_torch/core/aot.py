"""Schedule identity: the key under which a sealed step is cached.

Only :class:`ScheduleKey` of the JAX package's ``core/aot.py`` is ported so
far; ``AoTScheduler``, ``TaskSchedule`` and ``Nimble`` wait for the core
slice.  Arguments are flattened with ``torch.utils._pytree``.  A leaf that
stands in for an argument without data is a tensor on the ``meta``
device, the counterpart of ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _leaf_spec(leaf: Any) -> tuple[tuple[int, ...], str]:
    """(shape, dtype) of one flattened argument leaf.

    Works for tensors (meta ones included), numpy arrays and Python
    scalars alike — anything that can stand in for an example arg.
    """
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    name = str(dtype) if isinstance(dtype, torch.dtype) else str(np.dtype(dtype))
    return tuple(int(d) for d in shape), name


@dataclasses.dataclass(frozen=True)
class ScheduleKey:
    """Canonical hashable identity of one sealed schedule.

    A sealed step is reusable exactly when (a) it came from the same
    function, (b) the flattened argument shapes/dtypes/pytree-structure
    match (a captured graph is shape-specialized), and (c) the options that
    shaped it match.
    """

    fn_id: str
    tree: str                                      # pytree structure of args
    leaves: tuple[tuple[tuple[int, ...], str], ...]  # (shape, dtype) per leaf
    options: tuple[tuple[str, Any], ...]           # sorted options

    @classmethod
    def from_call(
        cls,
        fn: Callable,
        example_args: Sequence[Any],
        options: Sequence[tuple[str, Any]] = (),
        *,
        fn_id: Optional[str] = None,
    ) -> "ScheduleKey":
        if fn_id is None:
            mod = getattr(fn, "__module__", "")
            qual = getattr(fn, "__qualname__", repr(fn))
            # id() disambiguates closures sharing a qualname; holders (the
            # cache pins the fn object per entry) keep it from being reused.
            fn_id = f"{mod}.{qual}#{id(fn):x}"
        leaves, treedef = pytree.tree_flatten(tuple(example_args))
        return cls(
            fn_id=fn_id,
            tree=str(treedef),
            leaves=tuple(_leaf_spec(l) for l in leaves),
            options=tuple(sorted((str(k), v) for k, v in options)),
        )
