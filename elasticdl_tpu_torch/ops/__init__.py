"""Operators of the PyTorch port: hand-written CUDA kernels and their plain versions."""
