"""Model and RL configs (copies of ``repro.configs``)."""
