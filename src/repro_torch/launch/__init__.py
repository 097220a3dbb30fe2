"""Entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``."""
