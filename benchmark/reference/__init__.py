"""The plain float32 PyTorch reference the benchmark judges the port by.
It imports nothing of the port or of JAX."""
