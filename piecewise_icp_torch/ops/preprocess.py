"""Point-cloud preprocessing — counterpart of
``piecewise_icp_tpu/ops/preprocess.py`` (the parts on the pairwise device
path): voxel-grid downsampling on the host and the device SOR decision.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .grid_nn import CellGrid
from .nn_cuda import _chunk_rows, knn_sorted, nn1, sqdist

# Unresolved SOR queries (k+1-th neighbour beyond h: genuinely sparse
# points, the outliers SOR exists to find) re-measured exactly in-program.
# More than this many and the result is not certified (the caller falls
# back), exactly as in the reference.
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
    """Exact mean distance to the k nearest non-self neighbours, by
    successive DISTINCT-value min extraction with multiplicity (ties
    advance the rank by their count, like a sorted scan).  The query
    itself sits at rank 1, distance 0."""
    rows = _chunk_rows(targets.shape[0], targets.device)
    out = []
    for s in range(0, queries.shape[0], rows):
        d2 = sqdist(queries[s:s + rows, None, :], targets[None, :, :])
        nq = d2.shape[0]
        big = torch.tensor(1e30, dtype=d2.dtype, device=d2.device)
        acc = torch.zeros(nq, dtype=d2.dtype, device=d2.device)
        rank = torch.zeros_like(acc)
        cur = torch.full_like(acc, -1.0)
        budget = float(k + 1)
        for _ in range(k + 1):
            nxt = torch.where(d2 > cur[:, None], d2, big).min(dim=1).values
            cnt = (d2 == nxt[:, None]).sum(dim=1).to(d2.dtype)
            take = torch.clamp(budget - rank, min=0.0)
            take = torch.minimum(take, cnt)
            valid = nxt < big
            acc = acc + torch.where(
                valid, take * torch.sqrt(torch.clamp(nxt, min=0.0)), 0.0)
            rank = rank + torch.where(valid, take, 0.0)
            cur = torch.where(valid, nxt, cur)
        out.append(acc / torch.clamp(rank - 1.0, min=1.0))
    return torch.cat(out)


def sor_mask_sorted(grid: CellGrid, q_mask: torch.Tensor, k: int,
                    std_mult: float) -> Tuple[torch.Tensor, int]:
    """The SOR decision over the grid's cell-sorted self-join
    (counterpart of ``_sor_mask_sorted``).

    Exact (k+1)-NN distances through K2, mean neighbour distance, global
    mean/std, threshold.  Unresolved queries (k+1-th neighbour beyond h)
    are re-measured exactly by brute force when there are at most
    ``_SOR_RESCUE`` of them.  Returns (keep mask in SORTED order, number of
    unresolved queries); the caller must not trust the mask when that
    number exceeds ``_SOR_RESCUE``.
    """
    h = grid.h
    _, d, resolved = knn_sorted(grid, q_mask, k + 1)
    nb = d[:, 1:]                                  # drop self (distance 0)
    found = nb <= float(np.float32(h))
    cnt = torch.clamp(found.sum(dim=1), min=1)
    mean_d = torch.where(found, nb, 0.0).sum(dim=1) / cnt

    bad = q_mask & ~resolved
    bad_idx = torch.nonzero(bad).squeeze(1)
    n_bad = int(bad_idx.shape[0])
    if 0 < n_bad <= _SOR_RESCUE:
        mean_d[bad_idx] = _exact_knn_means(grid.points[bad_idx],
                                           grid.points, k)

    n = torch.clamp(q_mask.sum(), min=1)
    mu = torch.where(q_mask, mean_d, 0.0).sum() / n
    var = (torch.where(q_mask, (mean_d - mu) ** 2, 0.0).sum()
           / torch.clamp(n - 1, min=1))
    keep = q_mask & (mean_d <= mu + std_mult * torch.sqrt(var))
    return keep, n_bad


def percentile_c2c(target: torch.Tensor, source: torch.Tensor,
                   percentile: float,
                   t_mask: torch.Tensor | None = None,
                   s_mask: torch.Tensor | None = None) -> float:
    """The p-th percentile of source->target NN distances (index semantics
    of ``calArrayPercentileElement``).

    On the reference's TPU branch this is the brute Pallas kernel
    ``_nn1_kernel``, not yet ported to CUDA: on a CUDA tensor this raises.
    On the CPU the plain brute 1-NN runs.
    """
    if target.is_cuda:
        raise NotImplementedError(
            "percentile_c2c: nn1 kernel not yet ported (ROADMAP Queue B, "
            "K5 _nn1_kernel)")
    _, d = nn1(source, target, q_mask=s_mask, t_mask=t_mask)
    finite = torch.isfinite(d)
    n = finite.sum()
    d_sorted = torch.sort(torch.where(finite, d, torch.inf)).values
    idx = torch.clamp((n.to(torch.float32)
                       * torch.tensor(percentile, dtype=torch.float32)
                       ).to(torch.int64), 0, d.shape[0] - 1)
    return float(d_sorted[idx])
