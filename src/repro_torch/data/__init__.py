"""Synthetic data, as the JAX package's ``data``."""
from .pipeline import BatchSpec, Prefetcher, SyntheticLM, shard_batch

__all__ = ["BatchSpec", "SyntheticLM", "Prefetcher", "shard_batch"]
