"""Planar patches — counterpart of
``piecewise_icp_tpu/models/segmentation.py``.

:class:`PatchSet` (host numpy arrays, the same fields and dtypes as the
reference's) and the per-patch statistics as masked segment reductions
over one flat point array plus an int label array:

* reject patches with < 20 points, 2-sigma plane-residual trim
  (std = sqrt(sum d^2 / N)), re-reject < 20 after the trim;
* planarity gate on the trimmed covariance: variation <= 0.02 and
  planarity >= 0.25;
* centroid + 6 axis-extremal boundary points (Xmax, Xmin, Ymax, Ymin,
  Zmax, Zmin), first occurrence on ties;
* plane STD with denominator N-1 and centroid STD = STD / N (reference
  semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PiecewiseICPConfig

from ..ops import segment_ops as seg
from ..ops.eigh3 import eigvals3, smallest_eigvec3
from ..ops.transform import apply_transform_np

_FIELDS = ("points", "labels", "centroids", "boundary", "normals", "std_bp",
           "std_ct", "counts")


@dataclasses.dataclass
class PatchSet:
    """Planar-patch decomposition of one cloud (host numpy arrays)."""

    points: np.ndarray     # [N, 3] f32 — full preprocessed cloud
    labels: np.ndarray     # [N] int32 — compact patch id, -1 = unassigned
    centroids: np.ndarray  # [P, 3] f32
    boundary: np.ndarray   # [P, 6, 3] f32 (Xmax,Xmin,Ymax,Ymin,Zmax,Zmin)
    normals: np.ndarray    # [P, 3] f32 — patch plane normals
    std_bp: np.ndarray     # [P] f32 — plane-fit STD (denominator N-1)
    std_ct: np.ndarray     # [P] f32 — STD / N (reference semantics)
    counts: np.ndarray     # [P] int32 — points per patch after trim

    @property
    def num_patches(self) -> int:
        return self.centroids.shape[0]

    @classmethod
    def from_numpy(cls, obj) -> "PatchSet":
        """Copy any object with the PatchSet fields (such as the JAX
        package's PatchSet, whose fields are host numpy arrays)."""
        dt = dict(points=np.float32, labels=np.int32, centroids=np.float32,
                  boundary=np.float32, normals=np.float32,
                  std_bp=np.float32, std_ct=np.float32, counts=np.int32)
        return cls(**{f: np.array(getattr(obj, f), dtype=dt[f])
                      for f in _FIELDS})

    def to_numpy(self) -> dict:
        """The fields as a dict of numpy arrays."""
        return {f: getattr(self, f) for f in _FIELDS}

    def translated(self, delta: np.ndarray) -> "PatchSet":
        """Patch decomposition under a pure translation (membership, normals
        and STDs are translation-invariant)."""
        d = np.asarray(delta, dtype=np.float64)
        f32 = np.float32
        return PatchSet(
            points=(self.points.astype(np.float64) + d).astype(f32),
            labels=self.labels,
            centroids=(self.centroids.astype(np.float64) + d).astype(f32),
            boundary=(self.boundary.astype(np.float64) + d).astype(f32),
            normals=self.normals, std_bp=self.std_bp, std_ct=self.std_ct,
            counts=self.counts)

    def transformed(self, t: np.ndarray) -> "PatchSet":
        """Patch decomposition under a rigid transform (geometry maps,
        normals rotate, membership and STDs are invariant)."""
        t = np.asarray(t, dtype=np.float64)
        f32 = np.float32
        p = self.boundary.shape[0]
        return PatchSet(
            points=apply_transform_np(
                self.points.astype(np.float64), t).astype(f32),
            labels=self.labels,
            centroids=apply_transform_np(
                self.centroids.astype(np.float64), t).astype(f32),
            boundary=apply_transform_np(
                self.boundary.reshape(-1, 3).astype(np.float64),
                t).astype(f32).reshape(p, 6, 3),
            normals=(self.normals.astype(np.float64)
                     @ t[:3, :3].T).astype(f32),
            std_bp=self.std_bp, std_ct=self.std_ct,
            counts=self.counts)


def _patch_statistics(points: torch.Tensor, labels: torch.Tensor,
                      num_patches: int, min_pts: int, trim_sigma: float,
                      max_variation: float, min_planarity: float):
    """All per-patch statistics in one pass over raw supervoxel labels.

    Returns per raw patch: valid mask, trimmed-point mask (aligned with
    ``points``), centroid, boundary points, plane normal, std_bp, std_ct,
    trimmed count.
    """
    ids = labels

    cnt0 = seg.segment_count(ids, num_patches)
    ok0 = cnt0 >= min_pts

    cov1, mean1, n1 = seg.segment_cov3(points, ids, num_patches)
    vals1 = eigvals3(cov1)
    nrm1 = smallest_eigvec3(cov1, vals1[..., 2])
    safe = torch.clamp(ids, 0, num_patches - 1).long()
    d1 = torch.abs(((points - mean1[safe]) * nrm1[safe]).sum(dim=1))
    d1 = torch.where(ids >= 0, d1, 0.0)
    sum_d1sq = seg.segment_sum(d1 * d1, ids, num_patches)
    std1 = torch.sqrt(sum_d1sq / torch.clamp(n1, min=1.0))
    trim = (ids >= 0) & (d1 < trim_sigma * std1[safe])

    tids = torch.where(trim, ids, -1)

    cnt2 = seg.segment_count(tids, num_patches)
    ok2 = cnt2 >= min_pts

    cov2, mean2, n2 = seg.segment_cov3(points, tids, num_patches)
    vals2 = eigvals3(cov2)
    nrm2 = smallest_eigvec3(cov2, vals2[..., 2])
    e1 = torch.clamp(vals2[..., 0], min=1e-30)
    esum = torch.clamp(vals2[..., 0] + vals2[..., 1] + vals2[..., 2],
                       min=1e-30)
    variation = vals2[..., 2] / esum
    planarity = (vals2[..., 1] - vals2[..., 2]) / e1
    ok3 = (variation <= max_variation) & (planarity >= min_planarity)

    valid = ok0 & ok2 & ok3

    bp_idx = []
    for axis in range(3):
        v = points[:, axis]
        bp_idx.append(seg.segment_argmax(v, tids, num_patches))
        bp_idx.append(seg.segment_argmin(v, tids, num_patches))
    bp = points[torch.stack(bp_idx, dim=1)]      # [P, 6, 3]

    d2 = torch.abs(((points - mean2[safe]) * nrm2[safe]).sum(dim=1))
    d2 = torch.where(tids >= 0, d2, 0.0)
    sum_d2sq = seg.segment_sum(d2 * d2, tids, num_patches)
    std_bp = torch.sqrt(sum_d2sq / torch.clamp(n2 - 1.0, min=1.0))
    std_ct = std_bp / torch.clamp(n2, min=1.0)

    return (valid, trim, mean2, bp, nrm2, std_bp, std_ct,
            cnt2.to(torch.int32))


def build_patches(points: np.ndarray, sv_resolution: float,
                  cfg: Optional[PiecewiseICPConfig] = None,
                  resolution: float | None = None,
                  lattice_shift: np.ndarray | None = None,
                  lattice_offset: np.ndarray | None = None,
                  device: "str | torch.device" = "cuda") -> PatchSet:
    """Patch pipeline for one preprocessed cloud, on the device
    segmentation path (the reference's TPU branch).

    ``lattice_shift`` (world -> this frame) anchors the seed lattice to the
    world frame when ``cfg.seed_grid_align``; ``lattice_offset`` re-phases
    it (an independent patch draw, used by the acceptance guard).
    """
    from .segmentation_device import segment_patches_device

    cfg = cfg or PiecewiseICPConfig()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    k = min(cfg.knn_normals, max(n - 1, 1))

    seed_origin = None
    if cfg.seed_grid_align and n:
        ls = (np.zeros(3) if lattice_shift is None
              else np.asarray(lattice_shift, np.float64))
        mn = pts.astype(np.float64).min(axis=0)
        seed_origin = (np.floor((mn - ls) / sv_resolution) * sv_resolution
                       + ls)
    if lattice_offset is not None and n:
        base = (seed_origin if seed_origin is not None
                else pts.astype(np.float64).min(axis=0))
        seed_origin = base - np.mod(
            np.asarray(lattice_offset, np.float64), sv_resolution)

    ps, _nsv = segment_patches_device(
        pts, sv_resolution, k,
        resolution if resolution else sv_resolution / 10.0, cfg,
        seed_origin=seed_origin, device=device)
    return ps
