"""Model zoo of the PyTorch port."""
