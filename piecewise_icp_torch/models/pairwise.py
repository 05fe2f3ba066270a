"""Pairwise registration — counterpart of
``piecewise_icp_tpu/models/pairwise.py``.

Estimate the resolution when the config asks for it, preprocess (voxel
grid + SOR) and segment both clouds — on one shared grid each (the unified
path), or, for clouds the unified path declines, SOR then segmentation
(the staged path) — reduce to the target centroid, run the Piecewise-ICP
core, de-reduce the transform, optionally re-roll hard pairs (acceptance
guard), write the reports and, with ``isVisual``, the colored views.
Every entry point runs on ``device``, the card (``"cuda"``) unless the
caller names another; without a visible GPU that default raises.

With ``group`` (a :class:`~..parallel.ShardGroup`) every rank prepares
its own clouds (no collective) and runs the core point-sharded; only rank
0 writes the report, the ``isVisual`` views and the profiler trace, and a
barrier follows the writes.

Two environment variables reach this path, as in the JAX package:
``PWICP_NO_UNIFIED`` (any value) sends every cloud through the staged
path, and ``PWICP_PROFILE_DIR`` names a directory that receives a
``torch.profiler`` trace (Chrome trace JSON) of each ``register_pair``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from ..config import PiecewiseICPConfig
from ..io import formats, read_pcd, write_pcd
from ..utils.errors import PwICPError
from ..utils import viz
from ..utils.logging import PhaseTimer, gphase, log

from ..device import resolve_device
from ..ops.preprocess import (estimate_resolution, preprocess_cloud,
                              voxel_downsample)
from ..ops.transform import (apply_transform_np, matrix_to_angles,
                             matrix_to_params_gon, params_to_matrix,
                             translation_matrix)
from .piecewise_icp import PairResult, piecewise_icp
from .segmentation import PatchSet, build_patches
from .segmentation_device import preprocess_segment_device

ARC_TO_MGON = 1000.0 * 200.0 / np.pi   # rad -> milligon


@dataclasses.dataclass
class TargetState:
    """Preprocessed + segmented cloud in the target-reduced frame,
    reusable across pairs sharing the same target epoch."""

    shift: np.ndarray           # [3] f64 reduction shift (-centroid)
    reduced_points: np.ndarray  # [N1, 3] f32, reduced frame
    patches: PatchSet           # PatchSet of the reduced target
    resolution: float

    @classmethod
    def from_numpy(cls, shift, reduced_points, patches,
                   resolution: float) -> "TargetState":
        """Build from host arrays; ``patches`` may be any object with the
        PatchSet fields (such as the JAX package's PatchSet)."""
        return cls(shift=np.asarray(shift, np.float64),
                   reduced_points=np.asarray(reduced_points, np.float32),
                   patches=PatchSet.from_numpy(patches),
                   resolution=float(resolution))


def _resolution(points: np.ndarray, cfg: PiecewiseICPConfig, which: int,
                device: torch.device) -> float:
    """The configured resolution, or the estimated one when the config says
    ``isSetResSVsize: 0``."""
    if cfg.set_res_svsize:
        return cfg.res1 if which == 1 else cfg.res2
    return estimate_resolution(torch.from_numpy(
        np.ascontiguousarray(points, dtype=np.float32)).to(device))


def _sv_size(cfg: PiecewiseICPConfig, res: float, which: int) -> float:
    if not cfg.set_res_svsize:
        return res * cfg.sv_size_res_mult
    return cfg.svsize1 if which == 1 else cfg.svsize2


def _prepare_cloud(points: np.ndarray, cfg: PiecewiseICPConfig,
                   sor_mult: float, res: float, sv: float,
                   lattice_offset: np.ndarray | None, device: torch.device):
    """Voxel downsample, then one-grid SOR + segmentation (the unified
    path).  Returns (kept points [input frame and order], PatchSet [input
    frame]), or (kept points, None) when the unified path declines the
    cloud (fewer than 4,096 points after voxelisation, an extreme extent,
    too many unresolved SOR queries) or ``PWICP_NO_UNIFIED`` is set: the
    staged ``preprocess_cloud`` then runs and the caller segments the kept
    points itself."""
    if os.environ.get("PWICP_NO_UNIFIED"):
        return preprocess_cloud(points, res, cfg.sor_neighbors, sor_mult,
                                device), None
    with gphase("prep.voxel"):
        down = voxel_downsample(points, res)
    seed_origin = None
    mn = down.astype(np.float64).min(axis=0)
    if cfg.seed_grid_align:
        seed_origin = np.floor(mn / sv) * sv
    if lattice_offset is not None:
        base = seed_origin if seed_origin is not None else mn
        seed_origin = base - np.mod(
            np.asarray(lattice_offset, np.float64), sv)
    out = preprocess_segment_device(
        down, res, cfg.sor_neighbors, sor_mult, sv, cfg.knn_normals,
        cfg, seed_origin=seed_origin, device=device)
    if out is None:
        log.info("unified prep declined %d points: staged path", len(down))
        return preprocess_cloud(points, res, cfg.sor_neighbors, sor_mult,
                                device), None
    ps, _nsv, kept = out
    return kept, ps


def prepare_target(points1: Optional[np.ndarray], cfg: PiecewiseICPConfig,
                   sor_mult: float, resolution: float | None = None,
                   lattice_offset: np.ndarray | None = None,
                   prep_state: "TargetState | None" = None,
                   device: "str | torch.device" = "cuda") -> TargetState:
    """Preprocess + segment the target cloud once (reduced frame).

    ``prep_state``: a previous TargetState of the SAME cloud — reuses its
    preprocessing and shift and only re-segments (the acceptance guard's
    lattice re-roll).
    """
    dev = resolve_device(device)
    if prep_state is not None:
        res1, shift = prep_state.resolution, prep_state.shift
        red1 = prep_state.reduced_points
    else:
        res1 = resolution if resolution is not None \
            else _resolution(points1, cfg, 1, dev)
        kept, ps_in = _prepare_cloud(points1, cfg, sor_mult, res1,
                                     _sv_size(cfg, res1, 1), lattice_offset,
                                     dev)
        shift = -kept.astype(np.float64).mean(axis=0)
        red1 = (kept.astype(np.float64) + shift).astype(np.float32)
        if ps_in is not None:
            return TargetState(shift=shift, reduced_points=red1,
                               patches=ps_in.translated(shift),
                               resolution=res1)
    # the reduction shift maps world -> this frame: anchoring the seed
    # lattice through it keeps every epoch on one world voxelisation
    patches = build_patches(red1, _sv_size(cfg, res1, 1), cfg,
                            resolution=res1, lattice_shift=shift,
                            lattice_offset=lattice_offset, device=dev)
    return TargetState(shift=shift, reduced_points=red1, patches=patches,
                       resolution=res1)


@dataclasses.dataclass
class RegistrationOutput:
    """Full pairwise outcome in the original (unreduced) frame."""

    trans_mat: np.ndarray       # 4x4 f64
    vcm: np.ndarray             # 6x6 f64
    params_gon_m: np.ndarray    # (Rx,Ry,Rz [gon], tx,ty,tz [m])
    core: PairResult
    timer: PhaseTimer
    guard_draws: int = 1        # registrations run (1 = guard not fired)


def _params6(t: np.ndarray) -> np.ndarray:
    return np.concatenate([matrix_to_angles(t), t[:3, 3]])


@contextlib.contextmanager
def _profile_trace(profile_dir: Optional[str], dev: torch.device):
    """Trace the block with ``torch.profiler`` into ``profile_dir`` (one
    Chrome trace JSON a block); nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"register_pair_{os.getpid()}_"
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def register_pair(points1: Optional[np.ndarray],
                  points2: Optional[np.ndarray],
                  cfg: Optional[PiecewiseICPConfig] = None,
                  sor_mult: Optional[float] = None,
                  target_state: Optional[TargetState] = None,
                  source_state: Optional[TargetState] = None,
                  lattice_offset: np.ndarray | None = None,
                  initial_transform: np.ndarray | None = None,
                  device: "str | torch.device" = "cuda", group=None
                  ) -> RegistrationOutput:
    """Register cloud2 onto cloud1 (raw input clouds, original frame).

    Voxel + SOR preprocessing and segmentation -> centroid reduction to
    the PC1 centroid -> Piecewise-ICP core -> T_final = S^-1 T S, with the
    optional warm start (``initial_transform``) and the acceptance guard.
    With ``PWICP_PROFILE_DIR`` set, the call is traced into that directory
    (by rank 0 of a ``group``).
    """
    dev = resolve_device(device) if group is None \
        else group.local_device(device)
    trace_dir = os.environ.get("PWICP_PROFILE_DIR") \
        if group is None or group.is_root else None
    with _profile_trace(trace_dir, dev):
        return _register_pair(points1, points2, cfg or PiecewiseICPConfig(),
                              sor_mult, target_state, source_state,
                              lattice_offset, initial_transform, dev, group)


def _register_pair(points1, points2, cfg: PiecewiseICPConfig, sor_mult,
                   target_state, source_state, lattice_offset,
                   initial_transform, dev: torch.device, group
                   ) -> RegistrationOutput:
    timer = PhaseTimer()
    mult = sor_mult if sor_mult is not None else cfg.sor_std_mult_pair

    if target_state is None:
        with timer.phase("target"):
            target_state = prepare_target(points1, cfg, mult,
                                          lattice_offset=lattice_offset,
                                          device=dev)
    res1 = target_state.resolution
    shift = target_state.shift

    if source_state is not None:
        res2 = source_state.resolution
        patches2 = source_state.patches.translated(shift - source_state.shift)
        red2 = patches2.points
    else:
        with timer.phase("resolution"):
            res2 = _resolution(points2, cfg, 2, dev)
        with timer.phase("preprocess"):
            kept2, ps2_in = _prepare_cloud(
                points2, cfg, mult, res2, _sv_size(cfg, res2, 2),
                lattice_offset, dev)
        # staged path: the core segments the source itself (patches2 None)
        patches2 = None if ps2_in is None else ps2_in.translated(shift)
        red2 = (kept2.astype(np.float64) + shift).astype(np.float32)
    log.info("source: %d reduced pts | target: %d pts, %d patches",
             len(red2), len(target_state.reduced_points),
             target_state.patches.num_patches)

    # warm start: the guess only moves the starting point
    t_init = np.eye(4)
    if initial_transform is not None:
        t_init = np.asarray(initial_transform, dtype=np.float64)
        t_init_red = (translation_matrix(shift) @ t_init
                      @ translation_matrix(-shift))
        red2 = apply_transform_np(red2.astype(np.float64),
                                  t_init_red).astype(np.float32)
        if patches2 is not None:
            patches2 = patches2.transformed(t_init_red)

    def _core_run(tstate: TargetState, p2, off):
        with timer.phase("core"):
            c = piecewise_icp(tstate.reduced_points, red2, res1, res2, cfg,
                              patches1=tstate.patches, patches2=p2,
                              lattice_shift=tstate.shift,
                              lattice_offset=off, device=dev, group=group)
        s = translation_matrix(tstate.shift)
        s_inv = translation_matrix(-tstate.shift)
        return c, s_inv @ c.trans_mat @ s

    core, trans_final = _core_run(target_state, patches2, lattice_offset)
    n_draws = 1

    # acceptance guard: a low final stable ratio marks a hard pair whose
    # result depends on the patch draw — re-roll the seed-lattice phase
    # and GLS-fuse the three lowest-sigma0 draws
    if (cfg.guard_enabled and cfg.guard_draws > 1
            and lattice_offset is None
            and core.stable_ratio < cfg.guard_stable_ratio):
        log.info("acceptance guard: stable ratio %.3f < %.2f — running "
                 "%d extra lattice draws", core.stable_ratio,
                 cfg.guard_stable_ratio, cfg.guard_draws - 1)
        sv1 = _sv_size(cfg, res1, 1)
        draws = [(core, trans_final)]

        def _one_draw(d: int):
            off = np.asarray([((d + 1) * 0.381966) % 1.0,
                              ((d + 1) * 0.618034) % 1.0,
                              ((d + 1) * 0.5) % 1.0]) * sv1
            try:
                ts_d = prepare_target(None, cfg, mult, lattice_offset=off,
                                      prep_state=target_state, device=dev)
                draws.append(_core_run(ts_d, None, off))
            except PwICPError as e:
                log.info("guard draw %d degenerate (%s) — skipped", d, e)

        _one_draw(0)
        if len(draws) > 1:
            p0, p1_ = _params6(draws[0][1]), _params6(draws[1][1])
            se2 = (np.diag(np.asarray(draws[0][0].vcm))
                   + np.diag(np.asarray(draws[1][0].vcm)))
            z_dis = float(np.max(np.abs(p0 - p1_)
                                 / np.sqrt(np.maximum(se2, 1e-24))))
            if z_dis > cfg.guard_escalate_z:
                log.info("acceptance guard: draw disagreement %.1f sigma "
                         "— escalating to %d draws", z_dis,
                         cfg.guard_draws)
                for d in range(1, cfg.guard_draws - 1):
                    _one_draw(d)
            else:
                log.info("acceptance guard: draws agree (%.1f sigma) — "
                         "fusing the probe pair only", z_dis)
        n_draws = len(draws)
        if len(draws) > 1:
            s0 = np.array([c.sigma0 for c, _ in draws])
            top = np.argsort(s0)[:min(3, len(draws))]
            p6 = np.stack([_params6(t) for _, t in draws])
            w_sum = np.zeros((6, 6))
            b_sum = np.zeros(6)
            for i in top:
                w = np.linalg.inv(np.asarray(draws[int(i)][0].vcm)
                                  + 1e-18 * np.eye(6))
                w_sum += w
                b_sum += w @ p6[i]
            try:
                fused = np.linalg.solve(w_sum, b_sum)
            except np.linalg.LinAlgError:
                fused = p6[top].mean(axis=0)
            trans_final = params_to_matrix(fused)
            core = draws[int(top[0])][0]
            spread = np.ptp(p6, axis=0)
            log.info("acceptance guard: GLS-fused draws %s of %d by "
                     "sigma0 (%s mm); draw spread rot %.2f mgon, "
                     "trans %.3f mm", list(top), len(draws),
                     np.array2string(s0 * 1e3, precision=3),
                     spread[:3].max() * ARC_TO_MGON,
                     1e3 * spread[3:].max())

    if initial_transform is not None:
        trans_final = trans_final @ t_init
    params = matrix_to_params_gon(trans_final)
    log.info("final transform params (gon/m): %s", np.array2string(
        params, precision=6))
    return RegistrationOutput(trans_mat=trans_final, vcm=core.vcm,
                              params_gon_m=params, core=core, timer=timer,
                              guard_draws=n_draws)


def write_pair_report(out_prefix: "str | pathlib.Path",
                      result: RegistrationOutput,
                      source_points: Optional[np.ndarray] = None) -> None:
    """Write TransMatrix.txt (+ RegisteredSourceCloud.pcd)."""
    prefix = str(out_prefix)
    angles = matrix_to_angles(result.trans_mat)
    formats.write_trans_matrix_report(
        prefix + "TransMatrix.txt", result.trans_mat, angles,
        result.trans_mat[:3, 3], result.vcm)
    if source_points is not None:
        reg = apply_transform_np(source_points.astype(np.float64),
                                 result.trans_mat).astype(np.float32)
        write_pcd(prefix + "RegisteredSourceCloud.pcd", reg)


def write_visualizations(out_prefix: "str | pathlib.Path",
                         result: RegistrationOutput) -> None:
    """The reference's PCLVisualizer views as colored PCDs: the patches of
    both clouds and the stable / unstable split of the source."""
    core = result.core
    if core.patches2 is None:
        return
    prefix = str(out_prefix)
    viz.export_colored_patches(prefix + "Patches1_colored.pcd",
                               core.patches1.points, core.patches1.labels)
    viz.export_colored_patches(prefix + "Patches2_colored.pcd",
                               core.patches2.points, core.patches2.labels)
    if core.stable_point_mask is not None:
        viz.export_stable_unstable(prefix + "StableUnstable2.pcd",
                                   core.patches2.points,
                                   core.stable_point_mask)


def piecewise_icp_pair_call(confile: str, outfile: str,
                            device: "str | torch.device" = "cuda",
                            group=None, **overrides) -> bool:
    """Equivalent of the reference C ABI entry
    ``PiecewiseICP_pair_call(confile, outfile)``, on ``device`` (with
    ``group``, point-sharded over its ranks).  Returns False where the
    configuration or either cloud cannot be read."""
    try:
        cfg = PiecewiseICPConfig.from_reference_file(confile, **overrides)
    except (OSError, ValueError) as e:
        log.error("cannot read configuration file: %s", e)
        return False
    try:
        pts1 = read_pcd(cfg.path1)
        pts2 = read_pcd(cfg.path2)
    except Exception as e:  # any unreadable cloud is a failed call
        log.error("cannot load point clouds: %s", e)
        return False
    if len(pts1) < 1 or len(pts2) < 1:
        return False
    result = register_pair(pts1, pts2, cfg, device=device, group=group)
    if group is None or group.is_root:
        write_pair_report(outfile, result, source_points=pts2)
        if cfg.visual:
            write_visualizations(outfile, result)
            # the post-registration view of the original clouds
            reg = apply_transform_np(pts2.astype(np.float64),
                                     result.trans_mat).astype(np.float32)
            viz.export_three_clouds(str(outfile) + "ThreeClouds.pcd",
                                    pts1, pts2, reg)
        log.info("transformation results saved to %s", outfile)
    if group is not None:
        group.barrier()
    return True
