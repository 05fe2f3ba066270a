"""Device ops of the PyTorch port: transforms, eigensolves, segment
reductions, the grid index and the hand-written CUDA kernels with their
plain PyTorch versions (the names of ``piecewise_icp_tpu.ops``, bar those
the port does not carry).  Importing builds no kernel."""

from .eigh3 import eigh3, eigvals3, smallest_eigvec3
from .grid_nn import GridIndex, build_grid
from .preprocess import (estimate_resolution, overlap_ratio, percentile_c2c,
                         preprocess_cloud, sor_filter_mask, voxel_downsample)
from . import segment_ops, transform

__all__ = [
    "GridIndex", "build_grid",
    "eigh3", "eigvals3", "smallest_eigvec3",
    "estimate_resolution", "overlap_ratio", "percentile_c2c",
    "preprocess_cloud", "sor_filter_mask", "voxel_downsample",
    "segment_ops", "transform",
]
