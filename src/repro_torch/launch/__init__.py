"""Launchers (``repro.launch``): ``python -m repro_torch.launch.train``."""
