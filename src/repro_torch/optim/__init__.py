from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm, global_norm
from .schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "linear_warmup"]
