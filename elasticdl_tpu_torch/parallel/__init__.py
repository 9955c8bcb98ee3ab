"""The trainer of the PyTorch port, its process-group world, mesh and
collectives."""
