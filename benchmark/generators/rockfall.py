"""The rockfall series: a frozen copy of the program's
``utils/rockfall.py`` generator (a simulated permanent laser scanner's
series of a rock slope at the reference rockfall configuration's scale:
angular sampling from a scanner at the origin, planar rock facets, growing
rockfall scars, 5 mm range noise, millimetre / mgon rigid motion of the
scanner frame as the ground truth).  It returns the epochs instead of
writing files; the same generator state gives the same float32 values as
the program's files hold.  The program's
``seed`` argument is the ``rng`` passed in here."""

from __future__ import annotations

import numpy as np

from ._transform import apply_transform_np, params_to_matrix


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


def generate_rockfall(rng: np.random.Generator, n_epochs: int = 6,
                      extent: tuple[float, float] = (150.0, 100.0),
                      res: float = 0.3, range_noise: float = 0.005,
                      raster_jitter: bool = True,
                      with_scars: bool = True,
                      scene: np.random.Generator | None = None):
    """(epochs [float32 [N, 3]], ground truth [4x4]) of the series.

    ``scene`` draws the slope, its scars and the valley floor, ``rng`` the
    scanner's motion, raster and range noise; without ``scene`` both come
    from ``rng`` in the program's order.

    ``extent`` is the slope face size in metres; ``res`` the scan point
    spacing at the slope centre (the reference rockfall config assumes
    0.3 m).  Rock-structure feature sizes are fixed real-world metres —
    shrink ``extent`` (fewer facets/patches) and raise ``res`` (fewer
    points) for cheap test instances.
    """
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
    scene = rng if scene is None else scene
    relief = (_faceted_relief(scene, u, v, (U, V), cell=15.0,
                              slope=0.35, step=0.8)
              + _smooth_noise(scene, u, v, (U, V), 60.0, 4.0)
              + _smooth_noise(scene, u, v, (U, V), 1.0, 0.012))

    # rockfall scars: fixed centres, loss depth grows epoch over epoch
    n_scars = 3
    scar_c = np.stack([scene.uniform(0.2 * U, 0.8 * U, n_scars),
                       scene.uniform(0.35 * V, 0.85 * V, n_scars)], axis=1)
    scar_r = scene.uniform(6.0, 12.0, n_scars)
    # per-epoch depth increments [m]; >> DTmin=0.03 by later epochs
    growth = scene.uniform(0.04, 0.12, size=(n_epochs, n_scars))
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
          + _smooth_noise(scene, gx + U / 2, gy, (U, dist), 30.0, 1.2)
          + _smooth_noise(scene, gx + U / 2, gy, (U, dist), 1.0, 0.02))
    # boulders on the valley floor: steep x/y-facing faces at NEAR
    # ranges.  They anchor yaw-vs-translation (a wall at a single range
    # cannot: rotating about the scanner and translating back cancels
    # on the wall but shears everything at other ranges).
    n_boulders = max(int(U * 0.25), 4)
    bx = scene.uniform(-U / 2, U / 2, n_boulders)
    by = scene.uniform(0.18 * dist, 0.58 * dist, n_boulders)
    br = scene.uniform(1.2, 3.0, n_boulders)
    bh = scene.uniform(0.8, 2.5, n_boulders)
    for i in range(n_boulders):
        q2 = ((gx - bx[i]) ** 2 + (gy - by[i]) ** 2) / br[i] ** 2
        gz += bh[i] * np.clip(1.0 - q2, 0.0, None) ** 0.6
    ground = np.stack([gx, gy, gz], axis=1)

    # angular grid: ~`res` point spacing at the slope centre range
    ang_step = 0.9 * res / dist
    epochs = []
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
        epochs.append(apply_transform_np(p, np.linalg.inv(gt[k])).astype(
            np.float32))
    return epochs, gt


def make(rng: np.random.Generator, n_epochs: int,
         scene_seed: int | None = None, **kw):
    """The configuration's entry: :func:`generate_rockfall`, the scene
    from ``scene_seed`` where given (one slope watched by every run)."""
    scene = None if scene_seed is None else np.random.default_rng(scene_seed)
    return generate_rockfall(rng, n_epochs, scene=scene, **kw)
