"""Serving on the port: ``prefill`` and ``decode_step`` over the per-family
caches, the greedy ``make_serve_step`` and the host loop ``ServingEngine``."""
from .engine import (Request, ServingEngine, decode_step, left_pad,
                     make_serve_step, prefill)

__all__ = ["prefill", "decode_step", "make_serve_step", "left_pad",
           "Request", "ServingEngine"]
