"""The plain reference: PyTorch alone, nothing of the port, no JAX."""
