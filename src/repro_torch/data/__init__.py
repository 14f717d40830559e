from .pipeline import DataConfig, Prefetcher, SyntheticLM, data_config_for, shard_batch

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "data_config_for", "shard_batch"]
