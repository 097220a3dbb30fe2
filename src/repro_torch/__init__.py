"""PyTorch/CUDA port of the multi-hop split learning/inference planner.

The JAX package ``repro`` is the reference; this package is its port for an
NVIDIA H100, one slice at a time:

1. the batched planner: ``core`` (the problem types, the solver registry,
   the NumPy oracles and the ``dfts_torch`` / ``bcd_torch`` solvers) and
   ``kernels.minplus`` (the hand-written CUDA min-plus kernels: the fused
   DFTS scan, one launch a scan, and the product);
2. plan execution: ``configs`` (the model zoo's configs), ``models`` (the
   attention and SSD families; ``convert`` carries JAX weights over) and
   ``msl`` (``plan_pipeline`` over a model's pattern groups and the
   ``ChainSimulator`` that runs a plan stage by stage), through the
   hand-written CUDA kernels ``kernels.flash_attention`` and ``kernels.ssd``.

Importing the package touches no CUDA: a kernel is built and loaded at its
first launch, and the solvers and models run on the card only when called.
"""
