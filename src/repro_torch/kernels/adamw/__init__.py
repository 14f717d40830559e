from . import kernel
from .kernel import adamw_finish, adamw_step, adamw_sumsq
from .ref import adamw_step_ref, sumsq_ref

__all__ = ["adamw_finish", "adamw_step", "adamw_step_ref", "adamw_sumsq", "kernel", "sumsq_ref"]
