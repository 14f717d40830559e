from .pipeline import DataConfig, Prefetcher, SyntheticLM, data_config_for

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "data_config_for"]
