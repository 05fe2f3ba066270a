"""Point-cloud preprocessing — counterpart of
``piecewise_icp_tpu/ops/preprocess.py``: voxel-grid downsampling (the
host version, and on the device through K7), statistical outlier removal
(the unified path's device decision, the staged path's device SOR and its
small-cloud branch), resolution estimation, percentile C2C distances and
overlap ratios.

Every SOR decision runs on the device of its tensors: where the JAX
package hands a declined cloud to the native host statistic, the staged
path here re-measures every unresolved query exactly on the device, and
takes the brute k-NN when no grid fits the extent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.logging import gphase, log, note_sync, to_device, to_host

from .grid_nn import CellGrid, build_grid
from .nn_cuda import (knn_brute, knn_distances, knn_sorted, nn1_brute,
                      range_nn1)
from .voxel_cuda import voxel_centroids

# Unresolved SOR queries (k+1-th neighbour beyond h: genuinely sparse
# points, the outliers SOR exists to find) that the unified path re-measures
# exactly.  With more than this many it declines the cloud, as the
# reference does, and the staged path re-measures all of them.
_SOR_RESCUE = 4096


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Voxel-grid downsample: centroid of the points in each occupied voxel
    (PCL ``VoxelGrid`` semantics; output sorted by linearised voxel id)."""
    pts = np.asarray(points, dtype=np.float32)
    if pts.shape[0] == 0:
        return pts
    v = np.floor(pts.astype(np.float64) / leaf).astype(np.int64)
    vmin = v.min(axis=0)
    v -= vmin
    dims = v.max(axis=0) + 1
    lin = (v[:, 0] * dims[1] + v[:, 1]) * dims[2] + v[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    pts_sorted = pts[order].astype(np.float64)
    uniq, start = np.unique(lin_sorted, return_index=True)
    counts = np.diff(np.append(start, lin.shape[0]))
    sums = np.add.reduceat(pts_sorted, start, axis=0)
    centroids = sums / counts[:, None]
    return centroids.astype(np.float32)


def _exact_knn_means(queries: torch.Tensor, targets: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Exact mean distance to the k nearest non-self neighbours through K6
    (:func:`knn_brute` with the SOR-mean epilogue): the k+1 smallest
    distances with multiplicity, ties counted like a sorted scan.  The
    query itself sits at rank 1, distance 0."""
    return knn_brute(queries, targets, k + 1, epilogue="sor_mean")


def _sor_threshold(mean_d: torch.Tensor, valid: torch.Tensor,
                   std_mult: float) -> torch.Tensor:
    """keep = valid & mean_d <= mu + std_mult * sigma over the valid
    points (sample standard deviation)."""
    n = torch.clamp(valid.sum(), min=1)
    mu = torch.where(valid, mean_d, 0.0).sum() / n
    var = (torch.where(valid, (mean_d - mu) ** 2, 0.0).sum()
           / torch.clamp(n - 1, min=1))
    return valid & (mean_d <= mu + std_mult * torch.sqrt(var))


def sor_mask_sorted(grid: CellGrid, q_mask: torch.Tensor, k: int,
                    std_mult: float, rescue_max: int | None = _SOR_RESCUE
                    ) -> Tuple[torch.Tensor, int]:
    """The SOR decision over the grid's cell-sorted self-join
    (counterpart of ``_sor_mask_sorted``).

    Exact (k+1)-NN distances through K2, mean neighbour distance, global
    mean/std, threshold.  Unresolved queries (k+1-th neighbour beyond h)
    are re-measured exactly by the brute k-NN (K6) on the grid's device
    when there are at most ``rescue_max`` of them (all of them when it is
    None).  Returns (keep mask in SORTED order, number of unresolved
    queries); the caller must not trust the mask when that number exceeds
    ``rescue_max``.
    """
    h = grid.h
    _, d, resolved = knn_sorted(grid, q_mask, k + 1)
    nb = d[:, 1:]                                  # drop self (distance 0)
    found = nb <= float(np.float32(h))
    cnt = torch.clamp(found.sum(dim=1), min=1)
    mean_d = torch.where(found, nb, 0.0).sum(dim=1) / cnt

    bad = q_mask & ~resolved
    bad_idx = torch.nonzero(bad).squeeze(1)
    note_sync(bad)
    n_bad = int(bad_idx.shape[0])
    if 0 < n_bad and (rescue_max is None or n_bad <= rescue_max):
        mean_d[bad_idx] = _exact_knn_means(grid.points[bad_idx],
                                           grid.points, k)

    return _sor_threshold(mean_d, q_mask, std_mult), n_bad


def sor_filter_mask(points: torch.Tensor, mask: torch.Tensor | None = None,
                    k: int = 14, std_mult: float = 2.7) -> torch.Tensor:
    """Statistical outlier removal by brute k-NN (the small-cloud branch,
    at most 4,096 points, and clouds no grid fits): keep points whose mean
    distance to the ``k`` nearest neighbours is within mean + std_mult *
    std.  Returns a keep mask aligned with ``points``.  ``k`` is at most 31
    on every device (the brute k-NN's list holds k+1 <= 32 entries), where
    the JAX package takes any ``k``."""
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    # k+1 neighbours: the query itself is among them at distance 0
    d = knn_distances(points, points, k + 1, t_mask=mask)
    mean_d = torch.where(mask, d[:, 1:].sum(dim=1) / k, torch.inf)
    return _sor_threshold(mean_d, mask & torch.isfinite(mean_d), std_mult)


def sor_keep_mask_device(down: np.ndarray, resolution: float, sor_k: int,
                         sor_mult: float, device: torch.device
                         ) -> np.ndarray:
    """Device SOR over a downsampled cloud (the staged path): the grid
    self-join k-NN (K2) with every unresolved query re-measured exactly
    (``sor_mask_sorted`` without a budget), or the brute
    :func:`sor_filter_mask` when no grid fits the extent.  Returns the keep
    mask in the ORIGINAL point order."""
    h = max(1.5 * np.sqrt((sor_k + 1) / np.pi), 4.0) * resolution
    n = down.shape[0]
    with gphase("prep.sor.grid"):
        try:
            grid_index = build_grid(down, h)
        except ValueError:
            grid_index = None
    if grid_index is None:
        log.info("device SOR: no grid fits the extent; brute k-NN")
        with gphase("prep.sor.device"):
            pts = to_device(np.ascontiguousarray(down), device)
            return to_host(sor_filter_mask(pts, None, sor_k,
                                           sor_mult)).numpy()
    with gphase("prep.sor.grid"):
        grid = CellGrid.from_index(grid_index, device)
    with gphase("prep.sor.device"):
        keep_t, n_bad = sor_mask_sorted(
            grid, torch.ones(n, dtype=torch.bool, device=device), sor_k,
            sor_mult, rescue_max=None)
        if n_bad:
            log.info("device SOR: %d unresolved queries re-measured", n_bad)
        keep_sorted = to_host(keep_t).numpy()
    keep = np.empty(n, dtype=bool)
    keep[grid_index.ids[:n]] = keep_sorted
    return keep


def downsample_cloud(points: np.ndarray, leaf: float,
                     device: torch.device) -> np.ndarray:
    """:func:`voxel_downsample` of a host cloud on ``device``: the raw
    cloud goes up, K7 groups it on a CUDA device (the plain version on the
    CPU), and the centroids come back, the same bits."""
    pts = to_device(np.ascontiguousarray(points, dtype=np.float32), device)
    return to_host(voxel_centroids(pts, leaf)).numpy()


def preprocess_cloud(points: np.ndarray, resolution: float,
                     sor_k: int = 14, sor_mult: float = 2.7,
                     device: "torch.device | str" = "cuda") -> np.ndarray:
    """Voxel downsample at leaf=resolution, then SOR on ``device`` — the
    staged path (``PCpreprocessing``): the grid SOR above 4,096 points,
    brute k-NN at or below.  Returns a compact host array.  ``sor_k`` is
    at most 31 on every device (the k-NN kernels' lists hold sor_k+1 <= 32
    entries), where the JAX package takes any ``sor_k``."""
    dev = resolve_device(device)
    with gphase("prep.voxel"):
        down = downsample_cloud(points, resolution, dev)
    return sor_downsampled(down, resolution, sor_k, sor_mult, dev)


def sor_downsampled(down: np.ndarray, resolution: float, sor_k: int,
                    sor_mult: float, device: torch.device) -> np.ndarray:
    """The staged path's SOR of an already voxel-downsampled cloud (see
    :func:`preprocess_cloud`): the kept points of ``down``, in order."""
    with gphase("prep.sor"):
        if down.shape[0] > 4096:
            keep = sor_keep_mask_device(down, resolution, sor_k, sor_mult,
                                        device)
        else:
            keep = to_host(sor_filter_mask(
                to_device(np.ascontiguousarray(down), device), None,
                k=sor_k, std_mult=sor_mult)).numpy()
    return down[keep]


def estimate_resolution(points: torch.Tensor,
                        mask: torch.Tensor | None = None) -> float:
    """Mean distance to the nearest non-self neighbour
    (``calPCresolution``), by the brute k-NN (K6)."""
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    d1 = knn_distances(points, points, 2, t_mask=mask)[:, 1]
    valid = mask & torch.isfinite(d1)
    n = torch.clamp(valid.sum(), min=1)
    return float(to_host(torch.where(valid, d1, 0.0).sum() / n))


def percentile_c2c(target: torch.Tensor, source: torch.Tensor,
                   percentile: float,
                   t_mask: torch.Tensor | None = None,
                   s_mask: torch.Tensor | None = None) -> float:
    """The p-th percentile of source->target NN distances (index semantics
    of ``calArrayPercentileElement``: sort ascending, take element
    ``int(n * percentile)`` in float32), over the brute 1-NN (K5)."""
    _, d = nn1_brute(source, target, q_mask=s_mask, t_mask=t_mask)
    return percentile_of(d, percentile)


def percentile_of(d: torch.Tensor, percentile: float) -> float:
    """Element ``int(n * percentile)`` (float32 product) of the ascending
    finite distances ``d`` (inf entries are not counted)."""
    finite = torch.isfinite(d)
    n = finite.sum()
    d_sorted = torch.sort(torch.where(finite, d, torch.inf)).values
    idx = torch.clamp((n.to(torch.float32)
                       * to_device(percentile, d.device, torch.float32)
                       ).to(torch.int64), 0, d.shape[0] - 1)
    at = d_sorted[idx]
    note_sync(d)                    # a 0-dim device index is read first
    return float(to_host(at))


def _ratio(hits: int, n: int) -> float:
    """hits / n divided in float32, as the reference's device ratio."""
    return float(np.float32(hits) / np.float32(max(n, 1)))


def overlap_ratio(target: torch.Tensor, source: torch.Tensor,
                  dt_init: float, t_mask: torch.Tensor | None = None,
                  s_mask: torch.Tensor | None = None) -> float:
    """Fraction of source points whose NN distance to the target is
    < DTinit (``calOverlapRatioByC2Cdist``), over the brute 1-NN (K5)."""
    _, d = nn1_brute(source, target, q_mask=s_mask, t_mask=t_mask)
    finite = torch.isfinite(d)
    return _ratio(int(to_host((finite & (d < dt_init)).sum())),
                  int(to_host(finite.sum())))


def overlap_ratio_grid(target_grid: CellGrid, source: torch.Tensor,
                       dt_init: float) -> float:
    """Exact overlap ratio through K1 on a target grid with h == DTinit.

    Every source point whose true NN distance is < DTinit resolves within
    its 27-cell window, and K1 covers every query, so this equals the
    brute :func:`overlap_ratio`.  The ratio is order-free: queries need no
    cell sort.
    """
    if abs(target_grid.h - dt_init) > 1e-12 * max(dt_init, 1.0):
        raise ValueError("overlap grid must be built with h == dt_init")
    # every query live (no mask); a resolved distance is finite
    _, d, resolved, _ = range_nn1(source, None, target_grid)
    hit = resolved & (d < dt_init)
    return _ratio(int(to_host(hit.sum())), source.shape[0])
