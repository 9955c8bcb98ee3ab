"""Shared plumbing of the PyTorch port (copies of the reference's jax-free modules)."""
