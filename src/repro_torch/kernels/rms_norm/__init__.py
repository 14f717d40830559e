from . import backward, kernel
from .backward import rms_norm_bwd
from .ops import RMSNorm, rms_norm
from .ref import rms_norm_bwd_ref, rms_norm_ref

__all__ = ["RMSNorm", "backward", "kernel", "rms_norm", "rms_norm_bwd", "rms_norm_bwd_ref",
           "rms_norm_ref"]
