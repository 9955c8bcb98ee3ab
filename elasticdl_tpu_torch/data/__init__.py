"""Data codecs and record batches of the PyTorch port (numpy only)."""
