"""Device segmentation — counterpart of
``piecewise_icp_tpu/models/segmentation_device.py``.

SOR and supervoxel segmentation over ONE cell-sorted grid: the SOR k-NN
(K2), per-point neighbourhood statistics and normals (K3), seeded label
propagation (K4), then all patch statistics as segment reductions, with
one batched device-to-host fetch.  Seeds are chosen on the host exactly as
the reference chooses them (one per occupied supervoxel-size voxel, the
point nearest its centre), so labels are seed-slot ids directly comparable
with the reference's.

Everything on the device runs in the grid's cell-sorted order; one host
permutation restores the input order at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fetch, resolve_device
from ..ops.grid_nn import CellGrid, build_grid
from ..ops.preprocess import _SOR_RESCUE, sor_mask_sorted
from ..ops.seg_cuda import propagate_rounds, seg_stats
from ..utils.logging import gphase, log

_MAX_ROUNDS = 256           # propagation round cap (matches the host twin)


def _seg_h(k: int, resolution: float) -> float:
    """Grid cell size of segmentation: ~ the expected k-NN radius."""
    return float(max(1.2 * np.sqrt(k / np.pi), 3.0) * resolution)


def propagate_seeds(points: np.ndarray, resolution: float,
                    origin: np.ndarray | None = None) -> np.ndarray:
    """Deterministic seed indices: per occupied voxel, the point nearest
    the voxel centre (GridSample voxelisation, grid_sample.h:49-75).
    ``origin`` anchors the voxel lattice (must be <= the cloud minimum)."""
    pts = np.asarray(points, dtype=np.float64)
    mn = pts.min(axis=0) if origin is None else np.asarray(
        origin, np.float64)
    dims = ((pts.max(axis=0) - mn) / resolution).astype(np.int64) + 1
    cell = np.clip((pts - mn) / resolution, 0,
                   (dims - 1).astype(np.float64)).astype(np.int64)
    lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    ctr = mn + (cell + 0.5) * resolution
    d2c = ((pts - ctr) ** 2).sum(axis=1)
    order = np.lexsort((np.arange(len(pts)), d2c, lin))
    lin_sorted = lin[order]
    first = np.ones(len(pts), dtype=bool)
    first[1:] = lin_sorted[1:] != lin_sorted[:-1]
    return np.sort(order[first]).astype(np.int32)


def _seg_patches_fused(grid: CellGrid, q_mask: torch.Tensor,
                       seeds_sorted: np.ndarray, k: int,
                       sv_resolution: float, cfg):
    """Segmentation + all patch statistics; ONE batched fetch.

    Returns host arrays (labels [n] seed ids in SORTED order, valid [S],
    trim [n], centroids, boundary, normals, std_bp, std_ct, counts).
    """
    from .segmentation import _patch_statistics

    dev = grid.points.device
    t2, _cnt, normals = seg_stats(grid, q_mask, k)
    seed_idx = torch.from_numpy(seeds_sorted.astype(np.int64)).to(dev)
    lab_sorted, rounds = propagate_rounds(
        grid, normals, t2, q_mask, seed_idx, sv_resolution,
        max_rounds=_MAX_ROUNDS)
    log.info("label propagation: %d rounds", rounds)
    stats = _patch_statistics(grid.points, lab_sorted,
                              max(len(seeds_sorted), 1),
                              cfg.min_patch_points, cfg.patch_trim_sigma,
                              cfg.max_variation, cfg.min_planarity)
    return fetch(lab_sorted.to(torch.int32), *stats)


def _compact(labels_in: np.ndarray, trim_in: np.ndarray, valid: np.ndarray,
             n_seeds: int):
    """First-occurrence compaction of valid patches (input order), as the
    reference's host post-processing does it.  Returns (final labels,
    kept seed ids in order, number of used seeds)."""
    valid_pts = labels_in >= 0
    uniq, first_idx = np.unique(labels_in[valid_pts], return_index=True)
    pos_orig = np.flatnonzero(valid_pts)[first_idx]
    seeds_in_order = uniq[np.argsort(pos_orig)]
    keep_lab = seeds_in_order[valid[seeds_in_order]]
    s = max(n_seeds, 1)
    remap = np.full(s, -1, dtype=np.int32)
    remap[keep_lab] = np.arange(len(keep_lab), dtype=np.int32)
    final = np.where(trim_in & valid_pts,
                     remap[np.clip(labels_in, 0, s - 1)], -1).astype(np.int32)
    return final, keep_lab, len(uniq)


def segment_patches_device(points: np.ndarray, sv_resolution: float,
                           k: int, resolution: float, cfg,
                           seed_origin: np.ndarray | None = None,
                           device: "str | torch.device" = "cuda"):
    """Device segmentation and patch extraction of one (already
    preprocessed) cloud.  Returns (PatchSet, n_supervoxels)."""
    from .segmentation import PatchSet

    device = resolve_device(device)
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    k = min(k, max(n, 1))
    h = _seg_h(k, resolution)

    with gphase("seg.fused"):
        index = build_grid(pts, h)
        grid = CellGrid.from_index(index, device)
        seeds = propagate_seeds(index.points[:n], sv_resolution,
                                origin=seed_origin)
        q_mask = torch.ones(n, dtype=torch.bool, device=device)
        (lab_sorted, valid, trim, ct, bp, nrm, std_bp, std_ct,
         cnt) = _seg_patches_fused(grid, q_mask, seeds, k, sv_resolution,
                                   cfg)

    ids = index.ids[:n]
    labels_in = np.empty(n, dtype=np.int32)
    labels_in[ids] = lab_sorted
    trim_in = np.zeros(n, dtype=bool)
    trim_in[ids] = trim
    final, keep_lab, n_used = _compact(labels_in, trim_in, valid, len(seeds))
    nsv = n_used + int((labels_in < 0).sum())
    ps = PatchSet(points=pts, labels=final,
                  centroids=ct[keep_lab], boundary=bp[keep_lab],
                  normals=nrm[keep_lab], std_bp=std_bp[keep_lab],
                  std_ct=std_ct[keep_lab],
                  counts=cnt[keep_lab].astype(np.int32))
    log.info("supervoxels generated: %d (cloud %d pts)", nsv, n)
    log.info("selected patches: %d / %d (%.1f%% of points)",
             ps.num_patches, nsv, 100.0 * (final >= 0).sum() / max(n, 1))
    return ps, nsv


def preprocess_segment_device(down: np.ndarray, resolution: float,
                              sor_k: int, sor_mult: float,
                              sv_resolution: float, k: int, cfg,
                              seed_origin: np.ndarray | None = None,
                              device: "str | torch.device" = "cuda"):
    """SOR + full segmentation over ONE shared grid.

    ``down`` is the voxel-downsampled cloud in its input frame; the work
    runs in a centred frame (f32 at metre scale) and results are moved
    back.  SOR-removed points are moved to the 1e30 sentinel in place, so
    segmentation sees them as non-points.  Returns (PatchSet in the input
    frame, n_supervoxels, kept points [input frame and order]) or None
    when the cloud is too small or SOR cannot be certified exact (more
    than ``_SOR_RESCUE`` unresolved queries).
    """
    from .segmentation import PatchSet

    device = resolve_device(device)
    n = down.shape[0]
    if n < 4096:
        return None
    k = min(k, max(n, 1))
    shift0 = -down.astype(np.float64).mean(axis=0)
    pts_c = (down.astype(np.float64) + shift0).astype(np.float32)
    h = _seg_h(k, resolution)

    with gphase("prep.sor.grid"):
        try:
            index = build_grid(pts_c, h)
        except ValueError:
            return None
        grid = CellGrid.from_index(index, device)
    all_q = torch.ones(n, dtype=torch.bool, device=device)

    with gphase("prep.sor.device"):
        keep_t, n_bad = sor_mask_sorted(grid, all_q, sor_k, sor_mult)
        if n_bad > min(_SOR_RESCUE, n):
            log.info("unified SOR: %d unresolved > budget", n_bad)
            return None
        keep_sorted = keep_t.cpu().numpy()

    with gphase("seg.fused"):
        kept_sorted_idx = np.flatnonzero(keep_sorted)
        so = None if seed_origin is None else (
            np.asarray(seed_origin, np.float64) + shift0)
        seeds_kept = propagate_seeds(index.points[:n][keep_sorted],
                                     sv_resolution, origin=so)
        seeds_sorted = kept_sorted_idx[seeds_kept]
        pts2 = torch.where(keep_t[:, None], grid.points,
                           torch.tensor(1e30, dtype=torch.float32,
                                        device=device))
        (lab_sorted, valid, trim, ct, bp, nrm, std_bp, std_ct,
         cnt) = _seg_patches_fused(grid.with_points(pts2), keep_t,
                                   seeds_sorted, k, sv_resolution, cfg)

    ids = index.ids[:n]
    labels_in = np.full(n, -1, dtype=np.int32)
    labels_in[ids] = lab_sorted
    trim_in = np.zeros(n, dtype=bool)
    trim_in[ids] = trim
    kept_in = np.zeros(n, dtype=bool)
    kept_in[ids] = keep_sorted
    final, keep_lab, n_used = _compact(labels_in, trim_in, valid,
                                       len(seeds_sorted))
    nsv = n_used + int(((labels_in < 0) & kept_in).sum())

    kept_pts_in = down[kept_in]
    d = -shift0
    f32 = np.float32
    ps = PatchSet(
        points=kept_pts_in.astype(f32),
        labels=final[kept_in],
        centroids=(ct[keep_lab].astype(np.float64) + d).astype(f32),
        boundary=(bp[keep_lab].astype(np.float64) + d).astype(f32),
        normals=nrm[keep_lab],
        std_bp=std_bp[keep_lab], std_ct=std_ct[keep_lab],
        counts=cnt[keep_lab].astype(np.int32))
    log.info("supervoxels generated: %d (cloud %d pts, %d kept)", nsv, n,
             int(kept_in.sum()))
    log.info("selected patches: %d / %d (%.1f%% of points)",
             ps.num_patches, nsv,
             100.0 * (ps.labels >= 0).sum() / max(len(ps.labels), 1))
    return ps, nsv, kept_pts_in
