"""Engine pickling/rehydration contract for the multi-process plane.

The port of the JAX package's ``serving/spec.py``.  A live
:class:`~repro_torch.serving.engine.ServingEngine` cannot cross a process
boundary — its weights, KV cache and captured CUDA graphs are device state,
and a CUDA context dies with its process.  What *can* cross is the recipe:
an :class:`EngineSpec` is the small picklable object the parent ships to a
worker process, which
calls :meth:`EngineSpec.build` **in the worker** so the seal, the
weights, and the schedule cache all live (and die) with that device's
process.  The parent keeps only the spec and the scheduling-relevant
scalar it needs for admission control: ``max_slots``.

Contract:

* the spec (and everything it holds) must pickle — ship configs, seeds,
  and sizes, never arrays or engines;
* ``build(device_index, schedule_cache=None)`` runs in the worker
  process exactly once per registration; ``schedule_cache`` is the
  worker's shared per-device cache (pass it through so co-located lanes
  coalesce builds), and specs that ignore it may drop the keyword;
* ``max_slots`` must equal the built engine's slot capacity — the
  parent's lane proxy uses it for ``free_slots`` bookkeeping.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional, Union


def pickle_spec(spec: "EngineSpec") -> bytes:
    """Serialize an engine recipe for a process boundary or the request
    journal, verifying the round trip.

    Returns the pickle bytes after confirming they load back — a spec
    that captures an unpicklable closure or a live engine must fail
    loudly HERE, on the registering thread, not later inside a worker
    spawn or a journal recovery where the stack no longer points at the
    culprit.  Raises :class:`TypeError` with the offending spec named."""
    try:
        blob = pickle.dumps(spec)
        pickle.loads(blob)
    except Exception as exc:
        raise TypeError(
            f"engine spec {spec!r} is not picklable (specs must hold "
            f"configs/seeds/sizes, never arrays, engines, or closures): {exc}"
        ) from exc
    return blob


class EngineSpec:
    """Base rehydration recipe: subclass and implement :meth:`build`.

    ``max_slots`` (class or instance attribute) is read by the parent
    for slot accounting; everything else is yours."""

    max_slots: int = 4

    def build(self, device_index: int, schedule_cache: Any = None) -> Any:
        """Construct the engine in the worker process on ``device_index``."""
        raise NotImplementedError


@dataclasses.dataclass
class ServingEngineSpec(EngineSpec):
    """The real-model recipe: architecture name + sizes + init seed +
    device type.

    ``build`` resolves the config (``smoke=True`` keeps worker start-up
    CI-sized), draws the weights from a ``torch.Generator`` seeded with
    ``seed`` on the target device, and seals the engine's steps through the
    worker's shared cache — so registration cost is paid in the worker, and
    parent steppers still never capture.  ``device`` is ``"cuda"`` (the
    engine lands on ``cuda:{device_index}``; no card raises) or ``"cpu"``.
    The same seed on the same device gives the same weights, which is what
    makes a respawned worker or a journal recovery token-identical."""

    arch: str = "stablelm-1.6b"
    max_slots: int = 4
    max_len: int = 128
    bucketing: Union[str, tuple] = "pow2:8:32"
    seed: int = 0
    smoke: bool = True
    dtype: Optional[str] = "float32"
    device: str = "cuda"

    def target(self, device_index: int) -> Any:
        """The torch device this spec builds on for ``device_index``."""
        import torch

        if self.device == "cpu":
            return torch.device("cpu")
        if self.device != "cuda":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngineSpec(device='cuda') was built, but no CUDA "
                "device is available; set device='cpu' to serve on the CPU"
            )
        return torch.device("cuda", device_index % torch.cuda.device_count())

    def build(self, device_index: int, schedule_cache: Any = None) -> Any:
        """Rehydrate a :class:`~repro_torch.serving.engine.ServingEngine`."""
        import torch

        import repro_torch.configs as C
        from repro_torch.models import init_model

        from .engine import ServingEngine

        cfg = C.get(self.arch, smoke=self.smoke)
        if self.dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=self.dtype)
        device = self.target(device_index)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        params = init_model(gen, cfg, device=device)
        return ServingEngine(
            cfg, params, max_slots=self.max_slots, max_len=self.max_len,
            bucketing=self.bucketing, schedule_cache=schedule_cache,
            device=device,
        )
