"""Pipeline stages of the PyTorch port (pairwise registration slice)."""
