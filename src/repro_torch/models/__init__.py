"""The port's model stack: the attention, MoE, RG-LRU and SSD families on
the hand-written kernels, with the caches of serving, plus the planner's
cost profiles of every architecture."""
from . import convert, layers, profiles, transformer
from .layers import Ctx
from .transformer import forward, init_cache, init_params, logits_last

__all__ = ["convert", "layers", "profiles", "transformer", "Ctx", "forward",
           "init_cache", "init_params", "logits_last"]
