"""Dense decoder model in PyTorch (the JAX package's layouts)."""
