"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``minplus`` (the tropical product of the planner's DFTS scan)."""
