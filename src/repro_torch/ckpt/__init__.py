"""Checkpoints in the JAX package's on-disk format."""
from .checkpoint import CheckpointManager, flatten_with_path

__all__ = ["CheckpointManager", "flatten_with_path"]
