"""repro_torch.serving: continuous-batching inference over sealed steps.

:class:`ServingEngine` runs iteration-level continuous batching over
prefill/decode steps sealed once (CUDA graphs on the card) through a shared
``repro_torch.dispatch.ScheduleCache``; :class:`Request` is the unit of
traffic and :class:`EngineStats` the per-engine counter block.  The
picklable engine specs of the JAX package wait for the control-plane slice.
"""

from .engine import EngineStats, Request, ServingEngine

__all__ = ["EngineStats", "Request", "ServingEngine"]
