"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``minplus`` (the tropical product of the planner's DFTS scan),
``flash_attention`` (GQA attention of the attention family), ``ssd``
(Mamba-2's intra-chunk terms), ``moe_gmm`` (the per-expert matmul of the
MoE FFN) and ``rglru`` (the RG-LRU linear recurrence); ``ops`` exports their
entry points and ``ops.ssd_forward`` composes the SSD kernel with the
inter-chunk recurrence.  ``build`` compiles and loads them."""
