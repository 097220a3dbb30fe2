"""The port's model stack: the attention and SSD families on the
hand-written flash-attention and SSD kernels, plus the planner's cost
profiles of every architecture."""
from . import convert, layers, profiles, transformer
from .layers import Ctx
from .transformer import forward, init_params, logits_last

__all__ = ["convert", "layers", "profiles", "transformer", "Ctx", "forward",
           "init_params", "logits_last"]
