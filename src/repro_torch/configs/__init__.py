from .base import ARCH_IDS, ARCHS, ModelConfig, all_archs, get

__all__ = ["ARCH_IDS", "ARCHS", "ModelConfig", "all_archs", "get"]
