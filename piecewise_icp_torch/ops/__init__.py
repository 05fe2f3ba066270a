"""Device ops of the PyTorch port: transforms, eigensolves, segment
reductions, the grid index and the hand-written CUDA kernels with their
plain PyTorch versions."""
