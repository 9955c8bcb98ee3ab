"""The trainer of the PyTorch port (the predict slice so far)."""
