"""The online serving tier of the PyTorch port."""
