"""repro_torch.serving: continuous-batching inference over sealed steps.

:class:`ServingEngine` runs iteration-level continuous batching over
prefill/decode steps sealed once (CUDA graphs on the card) through a shared
``repro_torch.dispatch.ScheduleCache``; :class:`Request` is the unit of traffic
(also what the dispatch layer routes) and :class:`EngineStats` the
per-engine counter block.  :class:`EngineSpec` / :class:`ServingEngineSpec`
are the picklable rehydration recipes the multi-process worker plane
ships across process boundaries (engines themselves never pickle).
"""

from .engine import EngineStats, Request, ServingEngine
from .spec import EngineSpec, ServingEngineSpec

__all__ = [
    "EngineSpec",
    "EngineStats",
    "Request",
    "ServingEngine",
    "ServingEngineSpec",
]
