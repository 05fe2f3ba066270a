"""The rockfall series (BASELINE configurations 3 and 4) for the port.

The port's own copy of ``eval/rockfall_sim.py``: a simulated permanent-
laser-scanning series of a rock slope, with the operational traits of the
reference's Vals Valley rockfall data (angular sampling from a scanner at
the origin, so density falls with range; planar rock facets; growing
rockfall scars and debris fans far above DTmin; millimetre / mgon rigid
motion of the scanner frame as the ground truth; real-data file names
``SINGLESCANS - 210729_120011.pcd``), at the scale of the reference's
rockfall configuration (res 0.3 m, SV 3 m, DTinit 0.1 m, DTmin 0.03 m).
The same arguments and seed write the same bytes as the eval module.

``run_rockfall`` registers epochs 1 and 2 (configuration 3) and runs the
Kalman-smoothed 4D campaign through the file entry point (configuration
4), on the card unless the caller names the CPU:

    python -m piecewise_icp_torch.utils.rockfall [--epochs 6] [--mode -1]
        [--pair-only] [--device cuda] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..config import PiecewiseICPConfig
from ..io import write_pcd
from ..ops.transform import apply_transform_np, params_to_matrix

# monthly acquisition dates, July 2021 onward (matches the real series
# cadence: 2021-07-29 reference epoch, then ~monthly)
_DATES = ["210729_120011", "210830_180032", "210928_115958",
          "211027_120102", "211126_120005", "211228_120044",
          "220127_120030", "220226_120017", "220328_120021",
          "220427_120009"]


def _smooth_noise(rng: np.random.Generator, u: np.ndarray, v: np.ndarray,
                  extent: tuple[float, float], cell: float,
                  amp: float) -> np.ndarray:
    """Bilinearly interpolated random grid — one octave of rocky relief."""
    nu = int(extent[0] / cell) + 2
    nv = int(extent[1] / cell) + 2
    grid = rng.normal(scale=amp, size=(nu, nv))
    fu = np.clip(u / cell, 0, nu - 2)
    fv = np.clip(v / cell, 0, nv - 2)
    iu = fu.astype(np.int64)
    iv = fv.astype(np.int64)
    au = fu - iu
    av = fv - iv
    return ((grid[iu, iv] * (1 - au) + grid[iu + 1, iv] * au) * (1 - av)
            + (grid[iu, iv + 1] * (1 - au) + grid[iu + 1, iv + 1] * au) * av)


def _faceted_relief(rng: np.random.Generator, u: np.ndarray, v: np.ndarray,
                    extent: tuple[float, float], cell: float, slope: float,
                    step: float) -> np.ndarray:
    """Jittered-Voronoi planar facets — a fractured rock face.

    Sites on a jittered grid each carry a random plane (gradient up to
    ``slope``, height offset up to ``step``); every point takes the plane
    of its nearest site.  The result is piecewise planar with sharp
    ledges at facet boundaries.
    """
    nu = int(extent[0] / cell) + 2
    nv = int(extent[1] / cell) + 2
    su = (np.arange(nu)[:, None] + rng.uniform(0.35, 0.65, (nu, nv))) * cell
    sv = (np.arange(nv)[None, :] + rng.uniform(0.35, 0.65, (nu, nv))) * cell
    gh = rng.normal(scale=step, size=(nu, nv))
    gu = rng.uniform(-slope, slope, (nu, nv))
    gv = rng.uniform(-slope, slope, (nu, nv))

    iu = np.clip((u / cell).astype(np.int64), 1, nu - 2)
    iv = np.clip((v / cell).astype(np.int64), 1, nv - 2)
    best_d2 = np.full(u.shape, np.inf)
    w = np.zeros_like(u)
    for du_ in (-1, 0, 1):
        for dv_ in (-1, 0, 1):
            ju = iu + du_
            jv = iv + dv_
            d2 = (u - su[ju, jv]) ** 2 + (v - sv[ju, jv]) ** 2
            better = d2 < best_d2
            cand = (gh[ju, jv] + gu[ju, jv] * (u - su[ju, jv])
                    + gv[ju, jv] * (v - sv[ju, jv]))
            w = np.where(better, cand, w)
            best_d2 = np.where(better, d2, best_d2)
    return w


def generate_rockfall(out_dir: str, n_epochs: int = 6, seed: int = 7,
                      extent: tuple[float, float] = (150.0, 100.0),
                      res: float = 0.3, range_noise: float = 0.005,
                      raster_jitter: bool = True,
                      with_scars: bool = True) -> str:
    """Write `SINGLESCANS - *.pcd` epochs + defined_transformations.txt.

    ``extent`` is the slope face size in metres; ``res`` the scan point
    spacing at the slope centre (the reference rockfall config assumes
    0.3 m).  Rock-structure feature sizes are fixed real-world metres —
    shrink ``extent`` (fewer facets/patches) and raise ``res`` (fewer
    points) for cheap test instances.  Returns the scan folder path.
    """

    rng = np.random.default_rng(seed)
    scans = os.path.join(out_dir, "scans")
    os.makedirs(scans, exist_ok=True)

    # slope face geometry (slope-local frame): extent U x V metres.
    # The face is close enough to subtend a wide angle — together with
    # the valley-floor strip below this decouples rotations from
    # translations (a distant small face leaves that pair observable
    # only through the face extent, and the estimate slides).
    U, V = extent
    dist = 120.0                      # range to slope centre [m]
    gamma = np.deg2rad(55.0)          # face tilt from horizontal
    centre = np.array([0.0, dist, 50.0])
    e_u = np.array([1.0, 0.0, 0.0])
    e_v = np.array([0.0, np.cos(gamma), np.sin(gamma)])
    nrm = np.array([0.0, -np.sin(gamma), np.cos(gamma)])

    # surface parameter grid, finer than the scan spacing so angular
    # resampling (not the parameter grid) decides which points exist
    du = 0.45 * res
    uu, vv = np.meshgrid(np.arange(0, U, du), np.arange(0, V, du),
                         indexing="ij")
    u = uu.ravel()
    v = vv.ravel()
    # rock-face relief: planar facets (fractured-rock discontinuity
    # sets, ~5 patch-widths across so most patches sit inside one) over
    # a gentle large-scale bow, plus centimetre surface roughness.
    # Facets are the regime the method assumes — planar patches with
    # diverse normals constrain all 6 DOF — and patches spanning facet
    # edges are exactly what the planarity gates are there to reject.
    relief = (_faceted_relief(rng, u, v, (U, V), cell=15.0,
                              slope=0.35, step=0.8)
              + _smooth_noise(rng, u, v, (U, V), 60.0, 4.0)
              + _smooth_noise(rng, u, v, (U, V), 1.0, 0.012))

    # rockfall scars: fixed centres, loss depth grows epoch over epoch
    n_scars = 3
    scar_c = np.stack([rng.uniform(0.2 * U, 0.8 * U, n_scars),
                       rng.uniform(0.35 * V, 0.85 * V, n_scars)], axis=1)
    scar_r = rng.uniform(6.0, 12.0, n_scars)
    # per-epoch depth increments [m]; >> DTmin=0.03 by later epochs
    growth = rng.uniform(0.04, 0.12, size=(n_epochs, n_scars))
    growth[0] = 0.0
    if not with_scars:
        growth[:] = 0.0
    depth = np.cumsum(growth, axis=0)

    # ground truth: random walk of small rigid motions of the scanner
    # frame.  Rotations act over a ~250 m lever arm, so they must stay
    # small enough that the slope moves < DTinit=0.1 m per epoch
    # (matching the real configuration's assumption): ~4 mgon rotation
    # steps (~1.5 cm at range) + ~8 mm translation steps.
    gt = [np.eye(4)]
    for _ in range(1, n_epochs):
        step = params_to_matrix(np.concatenate([
            rng.normal(scale=6e-5, size=3),
            rng.normal(scale=8e-3, size=3)]))
        gt.append(gt[-1] @ step)

    # valley floor in front of the wall: a second, near-horizontal
    # surface band.  It adds the close-range/grazing-incidence density
    # regime of real PLS scans and the normal diversity that pins down
    # the remaining rigid-motion DOF.
    gdu = 0.3 * res
    gx, gy = np.meshgrid(
        np.arange(-U / 2, U / 2, gdu),
        np.arange(0.15 * dist, 0.62 * dist, gdu), indexing="ij")
    gx = gx.ravel()
    gy = gy.ravel()
    gz = (-2.0 + 0.03 * gy
          + _smooth_noise(rng, gx + U / 2, gy, (U, dist), 30.0, 1.2)
          + _smooth_noise(rng, gx + U / 2, gy, (U, dist), 1.0, 0.02))
    # boulders on the valley floor: steep x/y-facing faces at NEAR
    # ranges.  They anchor yaw-vs-translation (a wall at a single range
    # cannot: rotating about the scanner and translating back cancels
    # on the wall but shears everything at other ranges).
    n_boulders = max(int(U * 0.25), 4)
    bx = rng.uniform(-U / 2, U / 2, n_boulders)
    by = rng.uniform(0.18 * dist, 0.58 * dist, n_boulders)
    br = rng.uniform(1.2, 3.0, n_boulders)
    bh = rng.uniform(0.8, 2.5, n_boulders)
    for i in range(n_boulders):
        q2 = ((gx - bx[i]) ** 2 + (gy - by[i]) ** 2) / br[i] ** 2
        gz += bh[i] * np.clip(1.0 - q2, 0.0, None) ** 0.6
    ground = np.stack([gx, gy, gz], axis=1)

    # angular grid: ~`res` point spacing at the slope centre range
    ang_step = 0.9 * res / dist
    lines = []
    for k in range(n_epochs):
        w = relief.copy()
        for s in range(n_scars):
            r2 = (u - scar_c[s, 0]) ** 2 + (v - scar_c[s, 1]) ** 2
            sigma = scar_r[s] / 1.8
            scar = depth[k, s] * np.exp(-r2 / (2 * sigma * sigma))
            w -= np.where(r2 < (1.5 * scar_r[s]) ** 2, scar, 0.0)
            if depth[k, s] > 0:
                # debris fan accumulating BELOW the scar (down-slope = -v)
                fan_v = scar_c[s, 1] - 1.6 * scar_r[s]
                fr2 = ((u - scar_c[s, 0]) / 1.6) ** 2 + (v - fan_v) ** 2
                fan = 0.35 * depth[k, s] * np.exp(
                    -fr2 / (2 * (0.8 * scar_r[s]) ** 2))
                w += np.where(fr2 < (2.0 * scar_r[s]) ** 2, fan, 0.0)

        # plan-view curvature: the wall bends around the valley, so its
        # facet normals sweep a range of azimuths and ranges
        bend = (u - U / 2) ** 2 / (2.0 * 2.5 * U)
        pts = (centre[None, :]
               + (u - U / 2)[:, None] * e_u[None, :]
               + (v - V / 2)[:, None] * e_v[None, :]
               + (w - bend)[:, None] * nrm[None, :])
        pts = np.concatenate([pts, ground], axis=0)

        # TLS angular resampling: keep nearest return per angular cell
        az = np.arctan2(pts[:, 0], pts[:, 1])
        el = np.arctan2(pts[:, 2], np.hypot(pts[:, 0], pts[:, 1]))
        rngs = np.linalg.norm(pts, axis=1)
        jitter = (rng.uniform(0, ang_step, size=2) if raster_jitter
                  else np.zeros(2))                 # fresh scan raster
        ia = np.floor((az - az.min() + jitter[0]) / ang_step).astype(np.int64)
        ie = np.floor((el - el.min() + jitter[1]) / ang_step).astype(np.int64)
        cell_id = ia * (ie.max() + 1) + ie
        order = np.lexsort((rngs, cell_id))
        first = np.ones(len(order), dtype=bool)
        first[1:] = cell_id[order][1:] != cell_id[order][:-1]
        keep = order[first]
        p = pts[keep]

        # range noise along each ray (5 mm default)
        if range_noise > 0:
            ray = p / np.linalg.norm(p, axis=1, keepdims=True)
            p = p + ray * rng.normal(scale=range_noise, size=(len(p), 1))

        # scans are acquired in the MOVED scanner frame: apply inv(G_k)
        moved = apply_transform_np(p, np.linalg.inv(gt[k])).astype(
            np.float32)
        write_pcd(os.path.join(scans, f"SINGLESCANS - {_DATES[k]}.pcd"),
                  moved)
        lines.append(str(k + 1))
        for row in gt[k]:
            lines.append(" ".join(f"{val:.12f}" for val in row))
    with open(os.path.join(out_dir, "defined_transformations.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return scans


# the fields of the rockfall configuration that the reference's 11-line
# text file does not carry: the real data's timestamp format
FILE_OVERRIDES = dict(epoch_prefix="- ", epoch_digits=6)


def rockfall_config(scans: str, out_dir: str, res: float = 0.3,
                    sv: float = 3.0, **overrides) -> PiecewiseICPConfig:
    """The reference rockfall configuration
    (configuration_files/configuration_pair.txt) as a typed config."""
    kw = dict(path1=scans, path2=out_dir,
              set_res_svsize=True, res1=res, res2=res,
              svsize1=sv, svsize2=sv,
              set_dtinit=True, dt_init=0.1, dt_min=0.03, **FILE_OVERRIDES)
    kw.update(overrides)
    return PiecewiseICPConfig(**kw)


def run_rockfall(workdir: str, epochs: int = 6, mode: int = -1,
                 pair_only: bool = False,
                 extent: tuple[float, float] = (150.0, 100.0),
                 res: float = 0.3,
                 device: "str | torch.device" = "cuda") -> dict:
    """BASELINE configurations 3 (pairwise) and 4 (4D + Kalman) on the
    rockfall series in ``workdir`` (generated there when missing), on
    ``device``; returns the summary and writes it to
    ``rockfall_report.json``, with the keys of ``eval/rockfall_sim.run``."""
    import torch

    from ..device import resolve_device
    from ..io import formats, read_pcd
    from ..models.four_d import piecewise_icp_4d_call
    from ..models.pairwise import register_pair
    from ..ops.transform import matrix_to_params_gon
    from ..utils.logging import log

    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    os.makedirs(workdir, exist_ok=True)
    scans = os.path.join(workdir, "scans")
    if not os.path.isdir(scans) or len(os.listdir(scans)) < epochs:
        log.info("generating %d-epoch rockfall series...", epochs)
        scans = generate_rockfall(workdir, epochs, extent=tuple(extent),
                                  res=res)
    gt_file = os.path.join(workdir, "defined_transformations.txt")
    summary = {}

    # configuration 3: the pair of epochs 1 and 2 (the reference's
    # 210729 / 210830 pair)
    files = sorted(os.listdir(scans))
    pts1 = read_pcd(os.path.join(scans, files[0]))
    pts2 = read_pcd(os.path.join(scans, files[1]))
    cfg = rockfall_config(scans, workdir + "/", res=res)
    _, gt = formats.read_ground_truth_transforms(gt_file)
    sync()
    t0 = time.perf_counter()
    r = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_pair,
                      device=dev)
    sync()
    wall = time.perf_counter() - t0
    err = matrix_to_params_gon(r.trans_mat) - matrix_to_params_gon(gt[1])
    summary["pair"] = {
        "points": [len(pts1), len(pts2)],
        "rot_err_mgon": round(float(np.abs(err[:3]).max() * 1000), 2),
        "trans_err_mm": round(float(np.abs(err[3:]).max() * 1000), 3),
        "rot_std_mgon": [round(float(v), 3) for v in
                         np.sqrt(np.diag(r.vcm)[:3]) * 1000 * 200 / np.pi],
        "trans_std_mm": [round(float(v), 3) for v in
                         np.sqrt(np.diag(r.vcm)[3:]) * 1000],
        "wall_s": round(wall, 1)}
    log.info("rockfall pair: %s", summary["pair"])

    if not pair_only:
        # configuration 4: the 4D series with Kalman smoothing, through the
        # file entry point (the timestamp parser orders the epochs)
        out_dir = os.path.join(workdir, f"out_mode{mode}") + os.sep
        conf = os.path.join(workdir, f"config_4d_mode{mode}.txt")
        rockfall_config(scans, out_dir, res=res).to_reference_file(conf)
        sync()
        t0 = time.perf_counter()
        ok = piecewise_icp_4d_call(conf, 0, epochs, mode, overlap_thd=0.75,
                                   ground_truth=gt_file, device=dev,
                                   kalman_enabled=True, **FILE_OVERRIDES)
        sync()
        wall = time.perf_counter() - t0
        entry = {"ok": ok, "wall_s": round(wall, 1),
                 "epochs_per_s": round((epochs - 1) / wall, 4)}
        err_file = os.path.join(out_dir, "TransPara_AbsError.txt")
        if os.path.exists(err_file):
            e = formats.read_abs_errors(err_file)
            entry["mean_rot_mgon"] = [round(x, 2) for x in e[:, :3].mean(0)]
            entry["mean_trans_mm"] = [round(x, 3) for x in e[:, 3:].mean(0)]
            entry["max_rot_mgon"] = round(float(e[:, :3].max()), 2)
            entry["max_trans_mm"] = round(float(e[:, 3:].max()), 3)
        smoothed = os.path.join(out_dir, "TransPara_AbsError_smoothed.txt")
        if os.path.exists(smoothed):
            e = formats.read_abs_errors(smoothed)
            entry["kalman_smoothed"] = {
                "mean_rot_mgon": [round(x, 2) for x in e[:, :3].mean(0)],
                "mean_trans_mm": [round(x, 3) for x in e[:, 3:].mean(0)],
                "max_rot_mgon": round(float(e[:, :3].max()), 2),
                "max_trans_mm": round(float(e[:, 3:].max()), 3)}
        summary["four_d"] = entry
        log.info("rockfall 4d: %s", entry)

    with open(os.path.join(workdir, "rockfall_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m piecewise_icp_torch.utils.rockfall",
        description="BASELINE configurations 3 and 4 on the simulated "
        "rockfall series")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--mode", type=int, default=-1)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "pwicp_rockfall"))
    ap.add_argument("--pair-only", action="store_true")
    ap.add_argument("--extent", type=float, nargs=2, default=(150.0, 100.0))
    ap.add_argument("--res", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    summary = run_rockfall(args.workdir, epochs=args.epochs, mode=args.mode,
                           pair_only=args.pair_only,
                           extent=tuple(args.extent), res=args.res,
                           device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
