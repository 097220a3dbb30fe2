"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``minplus`` (the tropical product of the planner's DFTS scan),
``flash_attention`` (GQA attention of the attention family) and ``ssd``
(Mamba-2's intra-chunk terms), with ``ops.ssd_forward`` composing the SSD
kernel with the inter-chunk recurrence.  ``build`` compiles and loads them."""
