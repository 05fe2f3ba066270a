"""4D (time-series) registration — counterpart of
``piecewise_icp_tpu/models/four_d.py`` (``PiecewiseICP_4D_call``,
Registration.cpp:17-215).

Scan the epoch folder, plan the registration pairs (direct / fixed
interval / adaptive), register every pair on ``device``, persist each pair
as ``pairs/pair_NNNN.npz`` (the durable unit of work: resume and epoch
fleets read it), chain every epoch to the reference epoch with covariance
propagation, optionally Kalman-smooth the trajectory, and compare with the
ground truth when it is available.

Pair modes (python/main.py:27-35):
    0   all scans registered directly to the reference epoch
    > 0 fixed interval (register to epoch i+1-pairMode)
    < 0 adaptive interval via overlap-ratio search
"""

from __future__ import annotations

import functools
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PiecewiseICPConfig
from ..io import formats, read_pcd, scan_epoch_folder
from ..utils.errors import PwICPError
from ..utils.logging import PhaseTimer, gphase, log, to_device

from ..device import resolve_device
from ..ops.grid_nn import CellGrid, build_grid
from ..ops.preprocess import overlap_ratio, overlap_ratio_grid
from ..ops.transform import matrix_to_params_gon
from .chaining import absolute_errors, chain_to_reference
from .kalman import kalman_smooth_transforms
from .pairwise import prepare_target, register_pair, write_pair_report


def _mode_name(pair_mode: int) -> str:
    if pair_mode == 0:
        return "Direct2Ref_"
    return "Fixed_" if pair_mode > 0 else "Adaptive_"


def _load_cloud_cached(path: str) -> np.ndarray:
    """The cloud of ``path``, read again whenever the file's modification
    time or size changed since it was last read (a cache of 8 clouds,
    shared by the callers: they must not write into it)."""
    st = os.stat(path)
    return _read_cloud(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=8)
def _read_cloud(path: str, mtime_ns: int, size: int) -> np.ndarray:
    return read_pcd(path)


def adaptive_pair_sequence(file_list: Sequence[str], start_epoch: int,
                           dt_init: float, ratio_thd: float,
                           batch_window: int = 4,
                           device: "str | torch.device" = "cuda"
                           ) -> Tuple[Dict[int, int], Dict[int, float]]:
    """Adaptive registration-pair planning (``calAdaptivePairSequence``,
    Registration.cpp:552-589).

    For each source epoch j, advance the target from the last chosen one
    until the overlap ratio (fraction of C2C NN distances < DTinit)
    exceeds the threshold.  Returns {source: target} in indices relative
    to ``start_epoch`` and the measured ratios.

    Every epoch is loaded and gridded once (h = DTinit, reused by every
    source that scans it), and each overlap runs through K1
    (:func:`overlap_ratio_grid`); a target whose extent admits no dense
    grid takes the brute :func:`overlap_ratio` (K5).  The JAX package
    probes candidates in windows of ``batch_window`` to overlap its
    asynchronous dispatch; here each ratio is read as it is computed, so
    the scan is the plain sequential one, which gives the same plan, and
    ``batch_window`` is accepted for the reference's signature and unused.
    """
    dev = resolve_device(device)
    pairs: Dict[int, int] = {}
    ratios: Dict[int, float] = {}
    clouds: Dict[int, torch.Tensor] = {}
    grids: Dict[int, Optional[CellGrid]] = {}

    def cloud(i: int) -> torch.Tensor:
        if i not in clouds:
            pts = read_pcd(file_list[i])
            clouds[i] = to_device(pts, dev)
            with gphase("plan.grid"):
                try:
                    grids[i] = CellGrid.from_index(
                        build_grid(pts, h=dt_init), dev)
                except ValueError:
                    grids[i] = None     # the dense grid is infeasible here
        return clouds[i]

    idx_target = start_epoch
    for j in range(start_epoch + 1, len(file_list)):
        # targets advance monotonically: earlier epochs are not needed again
        for old in [k for k in list(clouds) if k < idx_target]:
            clouds.pop(old, None)
            grids.pop(old, None)
        src = cloud(j)
        ratio = 0.0
        for t in range(idx_target, j):
            tgt = cloud(t)
            if grids[t] is None:
                with gphase("plan.overlap_brute"):
                    ratio = overlap_ratio(tgt, src, dt_init)
            else:
                ratio = overlap_ratio_grid(grids[t], src, dt_init)
            idx_target = t
            if ratio > ratio_thd:
                break
        pairs[j - start_epoch] = idx_target - start_epoch
        ratios[j - start_epoch] = ratio
        log.info("adaptive pair: %d -> %d (overlap %.1f%%)",
                 j - start_epoch, idx_target - start_epoch, 100 * ratio)
    return pairs, ratios


def _find_ground_truth(input_folder: str,
                       explicit: Optional[str]) -> Optional[str]:
    """The ground-truth transform file: ``explicit``, the reference's
    hard-coded path, or ``defined_transformations.txt`` beside the scan
    folder."""
    candidates = []
    if explicit:
        candidates.append(explicit)
    candidates.append("data/data_synthetic/defined_transformations.txt")
    candidates.append(str(pathlib.Path(input_folder).parent
                          / "defined_transformations.txt"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


def piecewise_icp_4d_call(confile: str, start_epoch: int, epoch_num: int,
                          pair_mode: int, overlap_thd: float = 0.75,
                          ground_truth: Optional[str] = None,
                          shard_index: int = 0, shard_count: int = 1,
                          resume: bool = False, finalize: bool = True,
                          device: "str | torch.device" = "cuda",
                          group=None, **overrides) -> bool:
    """Equivalent of the reference C ABI entry ``PiecewiseICP_4D_call``
    (Registration.h:36), on ``device`` (with ``group``, every pair
    point-sharded over its ranks)."""
    try:
        cfg = PiecewiseICPConfig.from_reference_file(confile, **overrides)
    except (OSError, ValueError) as e:
        log.error("cannot read configuration file: %s", e)
        return False
    return run_4d(cfg, start_epoch, epoch_num, pair_mode, overlap_thd,
                  ground_truth=ground_truth, shard_index=shard_index,
                  shard_count=shard_count, resume=resume, finalize=finalize,
                  device=device, group=group)


def _write_whole(path: str, write) -> None:
    """``write(tmp)`` a temporary file in ``path``'s folder, then rename it
    to ``path``: another worker of an epoch fleet, which reads a pair file
    as soon as it exists, sees the whole file or none."""
    folder, name = os.path.split(path)
    # hidden, and with the file's own suffix (np.savez appends ".npz" to a
    # name that lacks it)
    tmp = os.path.join(folder, f".{os.getpid()}.{name}")
    write(tmp)
    os.replace(tmp, path)


def _write_param_table(path: str, ts_list, mats, vcms) -> None:
    with open(path, "w") as f:
        f.write(formats.TRANS_PARA_HEADER + "\n")
        for ts, tm, vcm in zip(ts_list, mats, vcms):
            f.write(formats.format_trans_para_row(
                ts, matrix_to_params_gon(tm), vcm) + "\n")


def run_4d(cfg: PiecewiseICPConfig, start_epoch: int, epoch_num: int,
           pair_mode: int, overlap_thd: float = 0.75,
           ground_truth: Optional[str] = None,
           shard_index: int = 0, shard_count: int = 1,
           resume: bool = False, finalize: bool = True,
           device: "str | torch.device" = "cuda", group=None) -> bool:
    """Run the 4D campaign on ``device``, optionally as one shard of an
    epoch fleet.

    Shards split the pair list into CONTIGUOUS ranges
    (``shard_index``/``shard_count``) over a shared output folder, so
    consecutive pairs inside one shard share their epoch preparation.
    Each finished pair is written to ``pairs/pair_NNNN.npz``; a later
    ``resume=True`` run, or whichever shard sees the full set, reads them
    and finalises (tables, chaining, Kalman smoothing, ground-truth errors,
    ``phase_timings.jsonl``).  Epoch shards compose with ``group``: each
    shard may run its pairs over a group of ranks.

    With ``group`` (a :class:`~..parallel.ShardGroup`) every rank plans
    and prepares every epoch itself (no collective: neither does the
    prefetch thread, since two threads on one communicator deadlock) and
    runs each pair point-sharded; only rank 0 writes files, each write
    followed by a barrier.  The campaign is the span ``campaign``.
    """
    with gphase("campaign"):
        return _run_4d(cfg, start_epoch, epoch_num, pair_mode, overlap_thd,
                       ground_truth, shard_index, shard_count, resume,
                       finalize, device, group)


def _run_4d(cfg: PiecewiseICPConfig, start_epoch: int, epoch_num: int,
            pair_mode: int, overlap_thd: float,
            ground_truth: Optional[str], shard_index: int, shard_count: int,
            resume: bool, finalize: bool, device: "str | torch.device",
            group) -> bool:
    from ..ops import _cuda

    dev = resolve_device(device) if group is None \
        else group.local_device(device)
    writer = group is None or group.is_root

    def written() -> None:
        if group is not None:
            group.barrier()

    if dev.type == "cuda":
        _cuda.lib()      # build and load once, before the prefetch thread
    timer = PhaseTimer("campaign.")
    input_folder, out_folder = cfg.path1, cfg.path2
    os.makedirs(out_folder, exist_ok=True)
    pairs_dir = os.path.join(out_folder, "pairs")
    os.makedirs(pairs_dir, exist_ok=True)

    files, times = scan_epoch_folder(input_folder, cfg.epoch_prefix,
                                     cfg.epoch_digits)
    log.info("%d scan files extracted from %s", len(files), input_folder)
    epoch_num = min(epoch_num, len(files))

    # ---- pair planning (adaptive mode, Registration.cpp:54-61) ----
    reg_pairs: Optional[Dict[int, int]] = None
    pair_file = os.path.join(out_folder, "RegPairFile.txt")
    if pair_mode < 0:
        if resume and os.path.exists(pair_file):
            # the plan depends only on the scans, DTinit and the threshold
            reg_pairs = formats.read_reg_pairs(pair_file)
        else:
            with timer.phase("pair_planning"):
                reg_pairs, _ = adaptive_pair_sequence(
                    files[:epoch_num], start_epoch, cfg.dt_init,
                    overlap_thd, device=dev)
            if writer:
                _write_whole(pair_file, lambda f: formats.write_reg_pairs(
                    f, reg_pairs))
            written()

    # ---- per-pair registrations (Registration.cpp:89-187) ----
    mode_name = _mode_name(pair_mode)
    n_pairs = max(epoch_num - 1 - start_epoch, 0)
    chunk = -(-n_pairs // max(shard_count, 1))

    def _owner(step: int) -> int:
        """Shard s owns steps [s*chunk+1, (s+1)*chunk]."""
        return min((step - 1) // max(chunk, 1), shard_count - 1)

    def _ref_of(i: int) -> int:
        step = i - start_epoch + 1
        if pair_mode > 0:
            return start_epoch if pair_mode >= step else i + 1 - pair_mode
        if pair_mode < 0:
            return start_epoch + reg_pairs[i + 1 - start_epoch]
        return start_epoch

    def _prepare(idx: int):
        with gphase("campaign.prepare", epoch=idx):
            return prepare_target(_load_cloud_cached(files[idx]), cfg,
                                  cfg.sor_std_mult_4d, device=dev)

    def _wait(idx: int, fut):
        with gphase("campaign.prefetch_wait", epoch=idx):
            return fut.result()

    epoch_states: Dict[int, object] = {}   # epoch idx -> TargetState
    ts_list: List[int] = []
    tm_list: List[Optional[np.ndarray]] = []
    vcm_list: List[Optional[np.ndarray]] = []
    failed: List[int] = []
    missing: List[int] = []

    # one-epoch lookahead: while pair k registers, one worker thread
    # (prefetch_0 in the span records) prepares pair k+1's missing epochs;
    # its kernels queue on the same device
    pending: Dict[int, object] = {}
    prev_direct_tm: Optional[np.ndarray] = None
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="prefetch") as prefetch_pool:
        for i in range(start_epoch, epoch_num - 1):
            step = i - start_epoch + 1
            ref_idx = _ref_of(i)
            ts_list.append(times[i + 1])
            pair_npz = os.path.join(pairs_dir, f"pair_{step:04d}.npz")

            # resume / other shards' pairs come from the durable files
            if os.path.exists(pair_npz) and (resume
                                             or _owner(step) != shard_index):
                d = np.load(pair_npz)
                tm_list.append(d["tm"])
                vcm_list.append(d["vcm"])
                if bool(d.get("failed", False)):
                    failed.append(step)
                else:
                    prev_direct_tm = d["tm"]
                continue
            if _owner(step) != shard_index:
                tm_list.append(None)
                vcm_list.append(None)
                missing.append(step)
                continue

            log.info("=== pair %d: epoch %d (target) <- epoch %d (source) "
                     "===", step, times[ref_idx], times[i + 1])
            try:
                # each epoch is prepared ONCE in its own centroid frame and
                # serves as target and source by pure translation
                for idx in (ref_idx, i + 1):
                    if idx not in epoch_states:
                        for old in [k for k in epoch_states if k < ref_idx]:
                            del epoch_states[old]
                        fut = pending.pop(idx, None)
                        epoch_states[idx] = (_wait(idx, fut)
                                             if fut is not None
                                             else _prepare(idx))
                nxt = i + 1
                if nxt < epoch_num - 1 \
                        and _owner(nxt - start_epoch + 1) == shard_index:
                    for idx in (_ref_of(nxt), nxt + 1):
                        if idx not in epoch_states and idx not in pending:
                            pending[idx] = prefetch_pool.submit(_prepare, idx)
                # direct mode: the previous direct estimate warm-starts the
                # next pair, whose raw misalignment may be basin-ambiguous
                t0_init = (prev_direct_tm
                           if pair_mode == 0 and cfg.warm_start_direct
                           else None)
                with timer.phase("pair", step=step):
                    result = register_pair(
                        None, None, cfg, sor_mult=cfg.sor_std_mult_4d,
                        target_state=epoch_states[ref_idx],
                        source_state=epoch_states[i + 1],
                        initial_transform=t0_init, device=dev, group=group)
                tm, vcm, was_failed = result.trans_mat, result.vcm, False
                prev_direct_tm = tm
                prefix = os.path.join(out_folder,
                                      f"{times[i + 1]}_{mode_name}")
                if writer:
                    with gphase("io.write_pair"):
                        write_pair_report(prefix, result)
            except PwICPError as e:
                log.error("step %d failed (%s); skipping to next", step, e)
                failed.append(step)
                # placeholder keeps the chaining indices aligned, flagged
                # by its huge variance
                tm, vcm, was_failed = np.eye(4), np.eye(6) * 1e6, True
            tm_list.append(tm)
            vcm_list.append(vcm)
            if writer:
                with gphase("io.write_pair"):
                    _write_whole(pair_npz, lambda f: np.savez(
                        f, tm=tm, vcm=vcm, failed=was_failed,
                        ts=times[i + 1]))
            written()
        for idx, fut in pending.items():    # prepared, never consumed
            try:
                _wait(idx, fut)
            except PwICPError as e:
                log.error("epoch %d preparation failed (%s)", times[idx], e)

    if missing:
        log.info("shard %d/%d: %d pairs done here; %d pairs belong to "
                 "other shards and are not yet on disk — skipping "
                 "finalisation (re-run with resume=True once all shards "
                 "finish)", shard_index, shard_count,
                 sum(t is not None for t in tm_list), len(missing))
        return len(failed) == 0
    if not finalize:
        return len(failed) == 0
    if writer:
        _finalize(cfg, out_folder, start_epoch, pair_mode, reg_pairs,
                  ts_list, tm_list, vcm_list, ground_truth, timer)
    written()
    if failed:
        log.warning("failed pairs: %s", failed)
    return len(failed) == 0


def _finalize(cfg: PiecewiseICPConfig, out_folder: str, start_epoch: int,
              pair_mode: int, reg_pairs, ts_list, tm_list, vcm_list,
              ground_truth: Optional[str], timer: PhaseTimer) -> None:
    """Chain to the reference epoch, smooth, then write the tables and
    the errors against the ground truth (the phase ``tables``) and dump
    the phase timings."""
    # ---- chain to the reference epoch (Registration.cpp:192-203) ----
    with timer.phase("chaining"):
        chained_t, chained_v = chain_to_reference(tm_list, vcm_list,
                                                  pair_mode, reg_pairs)

    # ---- Kalman smoothing ----
    smooth = None
    if cfg.kalman_enabled:
        with timer.phase("kalman"):
            smooth = kalman_smooth_transforms(chained_t, chained_v,
                                              cfg.kalman_process_noise)

    with timer.phase("tables"):
        _write_tables(cfg, out_folder, start_epoch, ts_list, tm_list,
                      vcm_list, chained_t, chained_v, smooth, ground_truth)
    timer.dump(os.path.join(out_folder, "phase_timings.jsonl"))


def _write_tables(cfg: PiecewiseICPConfig, out_folder: str,
                  start_epoch: int, ts_list, tm_list, vcm_list, chained_t,
                  chained_v, smooth, ground_truth: Optional[str]) -> None:
    """The transform and parameter tables (pairwise, chained, smoothed)
    and the absolute errors against the ground truth where it exists."""
    formats.write_trans_matrices(os.path.join(out_folder,
                                              "TransMatrices.txt"),
                                 ts_list, tm_list, vcm_list)
    _write_param_table(os.path.join(out_folder, "TransParameters.txt"),
                       ts_list, tm_list, vcm_list)
    formats.write_trans_matrices(
        os.path.join(out_folder, "TransMatrices_toRef.txt"),
        ts_list, chained_t, chained_v)
    _write_param_table(os.path.join(out_folder, "TransParameters_toRef.txt"),
                       ts_list, chained_t, chained_v)
    if smooth is not None:
        formats.write_trans_matrices(
            os.path.join(out_folder, "TransMatrices_toRef_smoothed.txt"),
            ts_list, smooth.trans_mats, list(smooth.covariances))
        _write_param_table(
            os.path.join(out_folder, "TransParameters_toRef_smoothed.txt"),
            ts_list, smooth.trans_mats, smooth.covariances)

    # ---- accuracy against ground truth (Registration.cpp:205-211) ----
    gt_path = _find_ground_truth(cfg.path1, ground_truth)
    if gt_path:
        _, gt_mats = formats.read_ground_truth_transforms(gt_path)
        gt_slice = gt_mats[start_epoch + 1: start_epoch + 1 + len(chained_t)]
        errors = absolute_errors(chained_t, gt_slice)
        formats.write_abs_errors(
            os.path.join(out_folder, "TransPara_AbsError.txt"), errors)
        log.info("mean abs errors (mgon/mm): %s",
                 np.array2string(errors.mean(axis=0), precision=3))
        if smooth is not None:
            errors_s = absolute_errors(smooth.trans_mats, gt_slice)
            formats.write_abs_errors(
                os.path.join(out_folder, "TransPara_AbsError_smoothed.txt"),
                errors_s)
            log.info("mean abs errors, smoothed (mgon/mm): %s",
                     np.array2string(errors_s.mean(axis=0), precision=3))
