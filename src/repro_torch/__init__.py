"""PyTorch + CUDA port of the A-3PO system (``repro``), for NVIDIA Hopper.

Imports ``torch``, numpy and the standard library only — never ``jax`` and
never the JAX package ``repro``. Module paths mirror ``repro`` so each
counterpart is easy to find. Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""
