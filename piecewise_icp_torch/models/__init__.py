"""Pipeline stages of the PyTorch port: segmentation into planar patches,
the Piecewise-ICP core loop and its inner ICP, the pair API, the 4D
campaign, chaining and Kalman smoothing (the names of
``piecewise_icp_tpu.models``, bar those the port does not carry)."""

from .segmentation import PatchSet, build_patches
from .piecewise_icp import PairResult, piecewise_icp
from .pairwise import (RegistrationOutput, piecewise_icp_pair_call,
                       register_pair, write_pair_report)
from .four_d import adaptive_pair_sequence, piecewise_icp_4d_call, run_4d
from .chaining import absolute_errors, chain_to_reference
from .kalman import SmoothedTrajectory, kalman_smooth_transforms
from .icp import compute_vcm, point_to_plane_icp

__all__ = [
    "PatchSet", "build_patches",
    "PairResult", "piecewise_icp",
    "RegistrationOutput", "piecewise_icp_pair_call", "register_pair",
    "write_pair_report",
    "adaptive_pair_sequence", "piecewise_icp_4d_call", "run_4d",
    "absolute_errors", "chain_to_reference",
    "SmoothedTrajectory", "kalman_smooth_transforms",
    "compute_vcm", "point_to_plane_icp",
]
