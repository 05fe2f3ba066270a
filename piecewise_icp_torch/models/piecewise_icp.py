"""The Piecewise-ICP core — counterpart of
``piecewise_icp_tpu/models/piecewise_icp.py``.

Iterative stable-patch classification under a monotonically decreasing
distance threshold (DT) with a Level-of-Detection floor.  The DT schedule
runs on the host; each iteration is one device step
(:func:`_iteration_step`): centroid/boundary correspondences, per-patch
LoD, stable/unstable classification, inner point-to-plane ICP, the
bounding-box convergence metric and, in stage 1, the 75th-percentile C2C
distance of the stable points through the grid 1-NN kernel (K1) with an
exact rescue of its unresolved queries through the brute 1-NN kernel (K5).
The transform and every per-iteration scalar come back to the host in ONE
packed fetch.

The inner ICP runs the reference objective through stage 1 and the
configured ``icp_variant`` from the stage-2 transition on; the
``icp_weighting`` applies in every stage.  After the loop, the Tukey
refine or, where it is off, the change screen (host float64) may drop
stable patches and re-solve on the rest.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import PiecewiseICPConfig
from ..utils.errors import DegenerateGeometryError
from ..utils.logging import gphase, log, note_sync, to_device, to_host

from ..device import fetch, resolve_device
from ..ops.grid_nn import CellGrid, build_grid
from ..ops.nn_cuda import nn1_brute, range_nn1_counted
from ..ops.preprocess import percentile_c2c
from ..ops.transform import (apply_transform, bounding_box_corner_change,
                             masked_aabb, matrix_to_angles, params_to_matrix)
from ..parallel.distributed import gather_rows
from .icp import _masked_nn, compute_vcm, point_to_plane_icp
from .segmentation import PatchSet, build_patches

# Unresolved stable queries of the stage-1 percentile re-measured exactly
# by the brute 1-NN (K5) in the step (the reference's TPU budget).  Only
# the unresolved queries are rescued.
_PCT_RESCUE = 49152


def _cell_order(points: np.ndarray, grid) -> np.ndarray:
    """Stable permutation sorting ``points`` by the linearised cell id of
    the target :class:`GridIndex`."""
    cell = np.floor((np.asarray(points, np.float64) - grid.origin)
                    / grid.h).astype(np.int64)
    dx, dy, dz = grid.dims
    cx = np.clip(cell[:, 0], 0, dx - 1)
    cy = np.clip(cell[:, 1], 0, dy - 1)
    cz = np.clip(cell[:, 2], 0, dz - 1)
    return np.argsort((cx * dy + cy) * dz + cz, kind="stable")


@dataclasses.dataclass
class PairResult:
    """Outcome of one pairwise Piecewise-ICP registration."""

    trans_mat: np.ndarray      # 4x4 f64 — core transform (reduced frame)
    vcm: np.ndarray            # 6x6 f64
    dt_series: List[float]
    iterations: int
    stable_ratio: float        # stable / total patch points, last iteration
    num_patches: tuple         # (P1, P2)
    patches1: "PatchSet | None" = None
    patches2: "PatchSet | None" = None
    stable_point_mask: "np.ndarray | None" = None  # over patches2.points
    total_icp_iters: int = 0
    sigma0: float = 0.0        # a-posteriori unit-weight std of the VCM fit
    final_n_stable: int = 0


def _classify_and_align(ct1, n1, std_ct1, ct1_mask, ct2, bp2, std_bp2,
                        ct2_mask, curr_dt, dt_min, max_lod, sv_sum,
                        icp_max_iterations, icp_trans_eps, icp_fitness_eps,
                        n2=None, icp_variant: str = "reference",
                        icp_weighting: str = "uniform", group=None):
    """Classification + inner ICP (Registration.cpp:735-877) with the
    ``icp_variant`` objective (``n2`` the source normals) and, for
    ``icp_weighting="inverse_variance"``, the rows weighted by the
    variances std_ct1**2 and std_bp2**2.  Classification runs on the
    replicated patch arrays; with ``group`` the inner ICP takes this
    rank's contiguous slice of the source rows (P2 padded with masked rows
    to a multiple of the ranks).
    Returns (T_icp 4x4, stable [P2], LoD_min, n_stable, icp_iters)."""
    p2 = ct2.shape[0]
    ct_idx, ct_dist = _masked_nn(ct2, ct2_mask, ct1, ct1_mask)
    bp2_mask = ct2_mask.repeat_interleave(6)
    bp_idx, _ = _masked_nn(bp2, bp2_mask, ct1, ct1_mask)

    sig1 = std_ct1[ct_idx]
    lod = 1.96 * torch.sqrt(sig1 * sig1 + std_bp2 * std_bp2)
    lod = torch.clamp(lod, dt_min, max_lod)
    lod_min = torch.where(ct2_mask, lod, torch.inf).min()

    pt2pl_ct = torch.abs(((ct1[ct_idx] - ct2) * n1[ct_idx]).sum(dim=1))
    pt2pl_bp = torch.abs(((ct1[bp_idx] - bp2) * n1[bp_idx]).sum(dim=1))
    pt2pl_bp = pt2pl_bp.reshape(p2, 6)

    thr = torch.maximum(curr_dt, lod)
    ct_pass = pt2pl_ct <= thr
    bp_pass = (pt2pl_bp <= thr[:, None]).all(dim=1)
    ptpt_pass = ct_dist < curr_dt + sv_sum
    stable = ct2_mask & ct_pass & bp_pass & ptpt_pass
    n_stable = stable.sum()

    weighted = icp_weighting == "inverse_variance"
    src, src_mask, src_n = ct2, stable, n2
    src_var = std_bp2 * std_bp2 if weighted else None
    if group is not None:
        src, src_mask = group.shard(ct2), group.shard(stable)
        src_n = None if n2 is None else group.shard(n2)
        src_var = None if src_var is None else group.shard(src_var)
    t_icp, icp_iters = point_to_plane_icp(
        ct1, n1, ct1_mask, src, src_mask,
        max_iterations=icp_max_iterations,
        transformation_eps=icp_trans_eps, fitness_eps=icp_fitness_eps,
        source_normals=src_n, symmetric=icp_variant == "symmetric",
        target_var=std_ct1 * std_ct1 if weighted else None,
        source_var=src_var, group=group)
    return t_icp, stable, lod_min, n_stable, icp_iters


def _stage1_percentile(cloud2, pt_stable, grid: CellGrid, percentile,
                       group=None):
    """The stage-1 percentile of stable source->target NN distances.

    K1 resolves every stable query whose nearest target lies within the
    grid's h and counts the rest; where that count (the one host read
    here) is 0 nothing else runs.  Otherwise the unresolved queries (the
    first ``_PCT_RESCUE`` by index at most) are re-measured by the brute
    1-NN (K5).  With ``group`` the queries are this rank's shard and the
    budget applies per shard; then ONE gather of the distances and ONE
    packed sum of the counts (after the branch on this rank's count, so
    every rank meets them).  Returns (d75, exact, n_unresolved) as device
    scalars."""
    _, d, resolved, strict, n_unresolved = range_nn1_counted(
        cloud2, pt_stable, grid)
    n_bad = int(to_host(n_unresolved))
    u = min(_PCT_RESCUE, n_bad)
    ok = resolved
    if n_bad:
        # masked queries count as resolved: these are stable ones
        ok = resolved.clone()
        if u:
            sel = torch.nonzero(~resolved).squeeze(1)[:u]
            note_sync(resolved)
            with gphase("core.stage1_rescue", queries=u):
                _, d[sel] = nn1_brute(cloud2[sel], grid.points)
            # a Python value would be uploaded by index_put_ itself
            ok[sel] = to_device(True, ok.device)
        d_ok = torch.where(ok, d, torch.inf)
    else:
        d_ok = d
    # stable, resolved (or rescued) stable, not strict, not all rescued,
    # unresolved
    counts = torch.cat([
        torch.stack([pt_stable.sum(), (ok & pt_stable).sum()]),
        to_device([int(not strict), int(n_bad > u), n_bad], d.device)])
    if group is not None:
        d_ok = group.gather(d_ok)
        (counts,) = group.sum_many(counts)
    idx = torch.clamp((counts[0].to(torch.float32)
                       * to_device(percentile, d.device, torch.float32)
                       ).to(torch.int64), 0, d_ok.shape[0] - 1)
    d_grid = torch.sort(d_ok).values[idx]
    note_sync(d_ok)                 # a 0-dim device index is read first
    # exact when every unresolved query was rescued, or under the
    # order-statistic argument (strict: unresolved => true distance > h,
    # and the percentile index lands in the resolved block)
    exact = (counts[3] == 0) | ((counts[2] == 0) & (idx < counts[1]))
    return d_grid, exact, counts[4]


def _iteration_step(ct1, n1, std_ct1, ct1_mask, ct2, n2, bp2, std_bp2,
                    ct2_mask, cloud2, cloud2_mask, labels2, grid,
                    curr_dt, dt_min, max_lod, sv_sum, bb_leaf, percentile,
                    need_percentile, cfg, icp_variant: str = "reference",
                    group=None):
    """One complete Piecewise-ICP iteration on the device, its inner ICP
    with the ``icp_variant`` objective and ``cfg.icp_weighting``.

    With ``group`` (a :class:`~..parallel.ShardGroup`) ``cloud2``, its
    mask and labels are this rank's shard and the patch arrays and grid
    are replicated; the stats come out the same on every rank.

    Returns (stats [24] f64 on the host — T_icp (16), LoD_min, n_stable,
    icp_iters, max_bb, d75, d75_exact, n_pt_stable, n_unresolved — then
    the device tensors stable, pt_stable and the moved source state)."""
    scal = {k: to_device(v, ct1.device, torch.float32) for k, v in dict(
        curr_dt=curr_dt, dt_min=dt_min, max_lod=max_lod, sv_sum=sv_sum,
        bb_leaf=bb_leaf).items()}
    t_icp, stable, lod_min, n_stable, icp_iters = _classify_and_align(
        ct1, n1, std_ct1, ct1_mask, ct2, bp2, std_bp2, ct2_mask,
        scal["curr_dt"], scal["dt_min"], scal["max_lod"], scal["sv_sum"],
        cfg.icp_max_iterations, cfg.icp_transformation_eps,
        cfg.icp_fitness_eps, n2=n2, icp_variant=icp_variant,
        icp_weighting=cfg.icp_weighting, group=group)

    # the reference's octree box: cubic, power-of-two side (leaf 2*Res2)
    bb_min, bb_max = masked_aabb(cloud2, cloud2_mask)
    if group is not None:
        bb_min, bb_max = group.min(bb_min), group.max(bb_max)
    extent = (bb_max - bb_min).max()
    leaf = torch.clamp(scal["bb_leaf"], min=1e-9)
    side = leaf * torch.exp2(torch.ceil(torch.log2(
        torch.clamp(extent / leaf, min=1.0))))
    max_bb = bounding_box_corner_change(bb_min, bb_min + side, t_icp)

    safe_lab = torch.clamp(labels2, 0, stable.shape[0] - 1)
    pt_stable = cloud2_mask & (labels2 >= 0) & stable[safe_lab]

    if need_percentile:
        d75, d75_exact, n_bad = _stage1_percentile(cloud2, pt_stable, grid,
                                                   percentile, group)
    else:
        d75 = to_device(torch.inf, ct1.device, torch.float32)
        d75_exact = to_device(True, ct1.device)
        n_bad = to_device(0, ct1.device)
    n_pt_stable = pt_stable.sum()
    if group is not None:
        n_pt_stable = group.sum(n_pt_stable)

    new_cloud2 = apply_transform(cloud2, t_icp)
    new_ct2 = apply_transform(ct2, t_icp)
    new_bp2 = apply_transform(bp2, t_icp)
    new_n2 = n2 @ t_icp[:3, :3].T
    stats = torch.cat([
        t_icp.reshape(-1).to(torch.float64),
        torch.stack([lod_min.to(torch.float64), n_stable.to(torch.float64),
                     to_device(float(icp_iters), ct1.device, torch.float64),
                     max_bb.to(torch.float64), d75.to(torch.float64),
                     d75_exact.to(torch.float64),
                     n_pt_stable.to(torch.float64),
                     n_bad.to(torch.float64)])])
    (stats_h,) = fetch(stats)
    return (stats_h, stable, pt_stable, new_cloud2, new_ct2, new_bp2,
            new_n2)


def _host_nn(targets: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """NN match over patch centroids on the host."""
    try:
        from scipy.spatial import cKDTree
        return cKDTree(targets).query(queries)[1]
    except ImportError:  # pragma: no cover
        d2 = ((queries[:, None, :] - targets[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1)


def _p2pl_rows_np(nrm: np.ndarray, q: np.ndarray) -> np.ndarray:
    return np.column_stack([
        nrm[:, 2] * q[:, 1] - nrm[:, 1] * q[:, 2],
        nrm[:, 0] * q[:, 2] - nrm[:, 2] * q[:, 0],
        nrm[:, 1] * q[:, 0] - nrm[:, 0] * q[:, 1],
        nrm[:, 0], nrm[:, 1], nrm[:, 2]])


def _robust_refine(ct1h: np.ndarray, n1h: np.ndarray, m1h: np.ndarray,
                   ct2h: np.ndarray, stableh: np.ndarray,
                   p1: int, p2: int, min_keep: int,
                   c_mult: float = 4.685, iters: int = 10):
    """Tukey M-estimator refinement of the final stable-centroid solve
    (host float64; a copy of the reference's).

    Returns (t_corr, keep, vcm_k, s0_k, vcm_all, s0_all), with the first
    four None when the screen is degenerate, or None when the rows are
    too few.
    """
    valid1 = np.flatnonzero(m1h[:ct1h.shape[0]])
    if p1:
        valid1 = valid1[valid1 < p1]
    s_idx = np.flatnonzero(stableh)
    s_idx = s_idx[s_idx < p2]
    ns = len(s_idx)
    if ns < max(min_keep * 2, 12) or len(valid1) == 0:
        return None

    c1 = ct1h[valid1].astype(np.float64)
    c2 = ct2h[s_idx].astype(np.float64)
    j = _host_nn(c1, c2)
    p = c1[j]
    nrm = n1h[valid1][j].astype(np.float64)

    t_total = np.eye(4)
    q = c2
    w = np.ones(ns)
    for _ in range(iters):
        a = _p2pl_rows_np(nrm, q)
        r = np.einsum("ij,ij->i", nrm, p - q)
        sigma = 1.4826 * np.median(np.abs(r - np.median(r)))
        c_t = c_mult * max(sigma, 1e-9)
        u = np.clip(r / c_t, -1.0, 1.0)
        w = (1.0 - u * u) ** 2
        aw = a * w[:, None]
        ata = aw.T @ a
        atl = aw.T @ r
        try:
            x = np.linalg.solve(ata + 1e-12 * np.eye(6), atl)
        except np.linalg.LinAlgError:
            return None
        t_d = params_to_matrix(x)
        q = q @ t_d[:3, :3].T + t_d[:3, 3]
        t_total = t_d @ t_total
        if np.abs(x).max() < 1e-10:
            break

    keep_local = w > 0.05
    n_keep = int(keep_local.sum())

    a_f = _p2pl_rows_np(nrm, q)
    r_f = np.einsum("ij,ij->i", nrm, p - q)

    def _vcm_of(sel: np.ndarray):
        a_k, r_k = a_f[sel], r_f[sel]
        ata = a_k.T @ a_k
        if abs(np.linalg.det(ata)) < 1e-9:
            log.warning("VCM normal matrix is near-singular")
            return None, None
        qxx = np.linalg.inv(ata)
        x_k = qxx @ (a_k.T @ r_k)
        v = a_k @ x_k - r_k
        s0 = float(v @ v) / max(int(sel.sum()) - 6, 1)
        return s0 * qxx, s0

    a_0 = _p2pl_rows_np(nrm, c2)
    r_0 = np.einsum("ij,ij->i", nrm, p - c2)
    try:
        qxx0 = np.linalg.inv(a_0.T @ a_0)
    except np.linalg.LinAlgError:
        return None
    x0 = qxx0 @ (a_0.T @ r_0)
    v0 = a_0 @ x0 - r_0
    s0_all = float(v0 @ v0) / max(ns - 6, 1)
    vcm_all = s0_all * qxx0

    if n_keep < max(min_keep, int(0.3 * ns)):
        return None, None, None, None, vcm_all, s0_all
    keep = stableh.copy()
    keep[s_idx[~keep_local]] = False
    vcm_k, s0_k = _vcm_of(keep_local)
    if vcm_k is None:
        return None, None, None, None, vcm_all, s0_all
    return t_total, keep, vcm_k, s0_k, vcm_all, s0_all


def _change_screen(ct1h: np.ndarray, n1h: np.ndarray, m1h: np.ndarray,
                   ct2h: np.ndarray, stableh: np.ndarray,
                   patches1: PatchSet, patches2: PatchSet,
                   k: int, z_thd: float, min_keep: int
                   ) -> np.ndarray | None:
    """Detect sub-LoD changed surface among the converged stable patches
    (host float64; a copy of the reference's).

    A stable patch on unchanged surface has a signed point-to-plane
    residual that is zero-mean noise, independent of its neighbours; a
    patch on sub-LoD changed surface shares its displacement with the
    neighbouring patches of the same change region.  The signed residuals
    are standardised (median and MAD), averaged over each patch's k
    nearest stable patches, and coherent offsets above z_thd / sqrt(k)
    are flagged.  ``PWICP_SCREEN_DUMP`` names an ``.npz`` that receives
    the per-patch screen state.

    Returns the screened patch-level keep mask ([P2] bool), or None when
    nothing is excluded or the screen would be degenerate.
    """
    p1 = patches1.num_patches
    p2 = patches2.num_patches
    valid1 = np.flatnonzero(m1h[:ct1h.shape[0]])
    valid1 = valid1[valid1 < p1] if p1 else valid1
    s_idx = np.flatnonzero(stableh)
    s_idx = s_idx[s_idx < p2]
    ns = len(s_idx)
    if ns < max(min_keep * 2, 12) or len(valid1) == 0:
        return None

    c1 = ct1h[valid1].astype(np.float64)
    c2 = ct2h[s_idx].astype(np.float64)
    j = _host_nn(c1, c2)
    nmatch = n1h[valid1][j].astype(np.float64)
    signed = np.einsum("ij,ij->i", c2 - c1[j], nmatch)

    se = np.sqrt(
        (patches1.std_bp[valid1][j] ** 2
         / np.maximum(patches1.counts[valid1][j], 1))
        + (patches2.std_bp[s_idx] ** 2
           / np.maximum(patches2.counts[s_idx], 1)))
    z = signed / np.maximum(se, 1e-12)
    med = np.median(z)
    mad = np.median(np.abs(z - med)) * 1.4826
    z = (z - med) / max(mad, 1e-12)

    kk = min(k, ns)
    nb = np.argpartition(
        ((c2[:, None, :] - c2[None, :, :]) ** 2).sum(-1), kk - 1,
        axis=1)[:, :kk]
    z_bar = z[nb].mean(axis=1)
    changed = np.abs(z_bar) > z_thd / np.sqrt(kk)

    dump = os.environ.get("PWICP_SCREEN_DUMP")
    if dump:
        np.savez(dump, pos=c2, signed=signed, se=se, z=z, z_bar=z_bar,
                 changed=changed, match_pos=c1[j])
    n_changed = int(changed.sum())
    if n_changed == 0:
        return None
    n_keep = ns - n_changed
    if n_keep < max(min_keep, int(0.3 * ns)):
        log.info("change screen: %d/%d patches flagged — too many to "
                 "refit safely, keeping the unscreened solution",
                 n_changed, ns)
        return None
    keep = stableh.copy()
    keep[s_idx[changed]] = False
    return keep


def piecewise_icp(cloud1: np.ndarray, cloud2: np.ndarray,
                  res1: float, res2: float,
                  cfg: Optional[PiecewiseICPConfig] = None,
                  patches1: Optional[PatchSet] = None,
                  patches2: Optional[PatchSet] = None,
                  lattice_shift: np.ndarray | None = None,
                  lattice_offset: np.ndarray | None = None,
                  device: "str | torch.device" = "cuda",
                  group=None) -> PairResult:
    """Register preprocessed ``cloud2`` onto ``cloud1`` (both centroid-
    reduced host float32 arrays) on ``device``.

    With ``group`` (a :class:`~..parallel.ShardGroup` whose ranks all call
    this with the same inputs, ``device`` being this rank's) the staged
    loop runs point-sharded: the patch rows are padded with masked rows
    and the source cloud, in target-cell order, with masked points to a
    multiple of the ranks; the cloud is split into contiguous shards, the
    patch arrays and the grid are replicated and checked bit-equal across
    the ranks once.  DT-init, the refine, the change screen and the VCM
    run replicated; the exact-percentile fallback and the final stable
    mask gather the shards first."""
    cfg = cfg or PiecewiseICPConfig()
    dev = resolve_device(device) if group is None \
        else group.local_device(device)

    if cfg.set_dtinit:
        curr_dt = float(cfg.dt_init)
    else:
        with gphase("core.dtinit"):
            curr_dt = percentile_c2c(
                to_device(cloud1, dev), to_device(cloud2, dev),
                cfg.dtinit_percentile) * cfg.dtinit_mult
    log.info("DT initial value = %g m", curr_dt)

    sv1 = cfg.svsize1 if cfg.set_res_svsize else res1 * cfg.sv_size_res_mult
    sv2 = cfg.svsize2 if cfg.set_res_svsize else res2 * cfg.sv_size_res_mult

    if patches1 is None:
        patches1 = build_patches(cloud1, sv1, cfg, resolution=res1,
                                 lattice_shift=lattice_shift,
                                 lattice_offset=lattice_offset, device=dev)
    if patches2 is None:
        patches2 = build_patches(cloud2, sv2, cfg, resolution=res2,
                                 lattice_shift=lattice_shift,
                                 lattice_offset=lattice_offset, device=dev)
    p1, p2 = patches1.num_patches, patches2.num_patches
    log.info("selected patches: PC1=%d PC2=%d", p1, p2)
    if p2 < cfg.min_stable_patches or p1 < cfg.min_stable_patches:
        raise DegenerateGeometryError(
            f"not enough patches: PC1={p1}, PC2={p2} (<4)")

    def up(a, dtype=None):
        t = to_device(np.ascontiguousarray(a), dev)
        return t if dtype is None else t.to(dtype)

    ct1 = up(patches1.centroids)
    n1 = up(patches1.normals)
    std_ct1 = up(patches1.std_ct)
    ct1_mask = torch.ones(p1, dtype=torch.bool, device=dev)
    # static target grid of the stage-1 percentile (cloud1 never moves)
    cloud1_index = build_grid(patches1.points, h=max(4.0 * res1, 1e-6))
    grid1 = CellGrid.from_index(cloud1_index, dev)

    def rows(t, value=0):
        """Rows padded to a multiple of the ranks (masked ones)."""
        return t if group is None else group.pad_rows(t, value)

    ct2 = rows(up(patches2.centroids))
    n2 = rows(up(patches2.normals))
    bp2 = rows(up(patches2.boundary)).reshape(-1, 3)
    std_bp2 = rows(up(patches2.std_bp))
    ct2_mask = rows(torch.ones(p2, dtype=torch.bool, device=dev), False)
    # the moving source cloud in TARGET-grid cell order (spatially coherent
    # queries); the stable mask is permuted back at the end
    c2_perm = _cell_order(patches2.points, cloud1_index)
    cloud2_t = up(patches2.points[c2_perm])
    n2pts = patches2.points.shape[0]
    cloud2_mask = torch.ones(n2pts, dtype=torch.bool, device=dev)
    labels2 = patches2.labels[c2_perm]
    labels2_t = up(labels2, torch.int64)
    if group is not None:
        group.check_replicated(
            ct1, n1, std_ct1, ct2, n2, bp2, std_bp2, cloud2_t, labels2_t,
            grid1.points, grid1.cell_starts, to_device(
                [curr_dt, res1, res2, sv1, sv2, p1, p2, n2pts, grid1.h,
                 *grid1.origin, *grid1.dims], dev, torch.float64))
        cloud2_t = group.shard(rows(cloud2_t))
        cloud2_mask = group.shard(rows(cloud2_mask, False))
        labels2_t = group.shard(rows(labels2_t, -1))

    dt_min = float(cfg.dt_min)
    max_lod = dt_min * cfg.lod_max_ratio
    sv_sum = float(sv1 + sv2)

    trans_mat = np.eye(4, dtype=np.float64)
    dt_series = [curr_dt]
    to_stage2 = to_stage3 = False
    bb1 = bb2 = 0.0
    vcm = np.zeros((6, 6))
    sigma0_sq = 0.0
    stable_ratio = 0.0
    iteration = 0
    total_icp_iters = 0
    max_outer = 100
    n_patch_pts = int((labels2 >= 0).sum())
    refine_will_run = cfg.robust_refine in (True, "always", "auto")

    while not to_stage3:
        iteration += 1
        if curr_dt <= dt_min:
            curr_dt = dt_min

        with gphase("core.iteration"):
            (stats, stable, pt_stable, new_cloud2, new_ct2, new_bp2,
             new_n2) = _iteration_step(
                ct1, n1, std_ct1, ct1_mask, ct2, n2, bp2, std_bp2, ct2_mask,
                cloud2_t, cloud2_mask, labels2_t, grid1, curr_dt, dt_min,
                max_lod, sv_sum, 2.0 * res2, cfg.dtinit_percentile,
                not to_stage2, cfg,
                # the symmetric objective is a refinement objective: its
                # bisector residual holds only once DT is small, so stage 1
                # runs the reference objective
                icp_variant=cfg.icp_variant if to_stage2 else "reference",
                group=group)

        t_icp = stats[:16].reshape(4, 4)
        (lod_min, n_stable, icp_iters, max_bb, d75, d75_exact,
         n_pt_stable, pct_bad) = stats[16:24]
        n_stable = int(n_stable)
        icp_iters = int(icp_iters)
        total_icp_iters += icp_iters
        if n_stable < cfg.min_stable_patches:
            raise DegenerateGeometryError(
                f"only {n_stable} stable patches left — not enough "
                f"overlapping area (iteration {iteration})")
        stable_ratio = int(n_pt_stable) / max(n_patch_pts, 1)

        if (not to_stage2) and max_bb < dt_min:
            to_stage2 = True
            log.info("DT changed to Stage 2 (BB %g < minLoD)", max_bb)
        elif curr_dt <= lod_min * (1 + 1e-6):
            to_stage3 = True
            log.info("DT changed to Stage 3 (End)")

        if not to_stage2:
            if pct_bad > 0:
                log.info("percentile: %d unresolved stable queries "
                         "rescued in-program (exact=%s)", int(pct_bad),
                         bool(d75_exact))
            if not bool(d75_exact):
                with gphase("core.percentile_exact"):
                    d75 = percentile_c2c(
                        grid1.points, gather_rows(cloud2_t, group),
                        cfg.dtinit_percentile,
                        s_mask=gather_rows(pt_stable, group))
            else:
                d75 = float(d75)
            if curr_dt > d75:
                curr_dt = d75
            else:
                to_stage2 = True
                log.info("DT changed to Stage 2 (percentile stalled)")
            if curr_dt <= lod_min:
                curr_dt = lod_min
            bb2, bb1 = bb1, max_bb
        if to_stage2 and not to_stage3:
            alpha = abs(bb1 / bb2) if bb2 != 0.0 else float("inf")
            if not np.isfinite(alpha):
                curr_dt *= cfg.dt_decay_hi
            else:
                curr_dt *= min(max(alpha, cfg.dt_decay_lo), cfg.dt_decay_hi)
            if curr_dt <= lod_min:
                curr_dt = lod_min
            bb2, bb1 = bb1, max_bb

        if (to_stage3 or iteration >= max_outer) \
                and not (refine_will_run and to_stage3):
            with gphase("core.vcm"):
                vcm, _, sigma0_sq = compute_vcm(
                    *fetch(ct1, n1, ct1_mask, ct2, stable))

        cloud2_t, ct2, bp2, n2 = new_cloud2, new_ct2, new_bp2, new_n2
        trans_mat = np.asarray(t_icp, dtype=np.float64) @ trans_mat
        dt_series.append(curr_dt)

        log.info("iter %d | DT=%.4f cm | stable=%d/%d (%.1f%% pts) | "
                 "BB=%.4g | icp_iters=%d | s2=%s s3=%s",
                 iteration, curr_dt * 100, n_stable, p2,
                 100 * stable_ratio, max_bb, int(icp_iters),
                 to_stage2, to_stage3)

        if iteration >= max_outer and not to_stage3:
            log.warning("DT schedule did not reach stage 3 in %d iterations;"
                        " terminating", max_outer)
            break

    rr_mode = cfg.robust_refine
    pt_stable_h = None
    if (refine_will_run or cfg.change_screen) and to_stage3:
        ct1h, n1h, m1h, ct2h, stableh = fetch(ct1, n1, ct1_mask, ct2, stable)
        with gphase("core.refine"):
            t_corr, keep, vcm_refined = None, None, None
            if refine_will_run:
                rr = _robust_refine(ct1h, n1h, m1h, ct2h, stableh, p1, p2,
                                    min_keep=cfg.min_stable_patches)
                if rr is None:
                    vcm, _, sigma0_sq = compute_vcm(ct1h, n1h, m1h, ct2h,
                                                    stableh)
                else:
                    (t_c, kp, vcm_k, s0_k, vcm_all, s0_all) = rr
                    accept = t_c is not None
                    if accept and rr_mode == "auto":
                        # accept only a significant correction, or a
                        # suspect (low stable ratio) pair
                        dp = np.concatenate([matrix_to_angles(t_c),
                                             t_c[:3, 3]])
                        z_corr = float(np.max(np.abs(dp) / np.sqrt(
                            np.maximum(np.diag(vcm_k), 1e-24))))
                        accept = (z_corr > 2.0
                                  or stable_ratio < cfg.guard_stable_ratio)
                        if not accept:
                            log.info("robust refine: correction not "
                                     "significant (z=%.1f) — keeping the "
                                     "reference-semantics solution", z_corr)
                    if accept:
                        t_corr, keep = t_c, kp
                        vcm_refined, sigma0_sq = vcm_k, s0_k
                    else:
                        vcm, sigma0_sq = vcm_all, s0_all
            elif cfg.change_screen:
                keep = _change_screen(
                    ct1h, n1h, m1h, ct2h, stableh, patches1, patches2,
                    k=cfg.change_screen_k, z_thd=cfg.change_screen_z,
                    min_keep=cfg.min_stable_patches)
                if keep is not None:
                    # the reference objective, uniform weights, on the
                    # kept patches
                    t_icp_corr, _ = point_to_plane_icp(
                        ct1, n1, ct1_mask, ct2, up(keep),
                        max_iterations=cfg.icp_max_iterations,
                        transformation_eps=cfg.icp_transformation_eps,
                        fitness_eps=cfg.icp_fitness_eps)
                    (t_corr,) = fetch(t_icp_corr)
                    t_corr = t_corr.astype(np.float64)
            if t_corr is not None and keep is not None:
                trans_mat = t_corr @ trans_mat
                if vcm_refined is not None:
                    vcm = vcm_refined
                else:
                    vcm, _, sigma0_sq = compute_vcm(ct1h, n1h, m1h, ct2h,
                                                    keep)
                n_excl = int(stableh.sum()) - int(keep.sum())
                n_stable = int(keep.sum())
                # per-point stability follows the kept patch set
                safe_lab2 = np.clip(labels2, 0, keep.shape[0] - 1)
                pt_stable_h = (labels2 >= 0) & keep[safe_lab2]
                stable_ratio = int(pt_stable_h.sum()) / max(n_patch_pts, 1)
                log.info("robust refine: %d/%d stable patches rejected "
                         "(sub-LoD change), |dT|=%.3g mm",
                         n_excl, n_excl + n_stable,
                         1e3 * float(np.linalg.norm(t_corr[:3, 3])))

    if pt_stable_h is None:
        (pt_stable_h,) = fetch(gather_rows(pt_stable, group))
    stable_mask = np.empty(n2pts, dtype=bool)
    stable_mask[c2_perm] = pt_stable_h[:n2pts]
    return PairResult(trans_mat=trans_mat, vcm=vcm, dt_series=dt_series,
                      iterations=iteration, stable_ratio=stable_ratio,
                      num_patches=(p1, p2), patches1=patches1,
                      patches2=patches2, stable_point_mask=stable_mask,
                      total_icp_iters=total_icp_iters,
                      sigma0=float(np.sqrt(max(sigma0_sq, 0.0))),
                      final_n_stable=int(n_stable))
