"""The worker task loop of the PyTorch port."""
