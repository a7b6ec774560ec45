from repro_torch.kernels.adam.ops import adam_update, global_norm  # noqa: F401
