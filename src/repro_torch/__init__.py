"""PyTorch/CUDA port of the multi-hop split learning/inference planner.

The JAX package ``repro`` is the reference; this package is its port for an
NVIDIA H100, one slice at a time.  The first slice is the batched planner:
``core`` (the problem types, the solver registry, the NumPy oracles and the
``dfts_torch`` / ``bcd_torch`` solvers) and ``kernels.minplus`` (the
hand-written CUDA min-plus kernel of the DFTS scan).

Importing the package touches no CUDA: a kernel is built and loaded at its
first launch, and the solvers run on the card only when called.
"""
