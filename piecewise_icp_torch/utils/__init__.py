"""Helpers of the PyTorch port that import neither JAX nor the JAX package."""
