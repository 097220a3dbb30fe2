"""Entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``."""
from __future__ import annotations

from ..configs.base import ModelConfig

# The JAX package's reduced configs have a head width of 16, which the
# flash-attention kernel does not take (``kernels/flash_attention.py``
# HEAD_DIMS); the launchers' reduced configs take its smallest, 32, on
# every device, so that a CPU run and a card run train the same model.
REDUCED_HEAD_DIM = 32


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg.reduced()`` with the head width the card's kernels take."""
    return cfg.reduced(head_dim=REDUCED_HEAD_DIM)
