"""The scaled 4D campaign (BASELINE configuration 5) for the port.

The port's own counterpart of ``eval/scale_demo.py``, ``eval/fleet_demo.py``
and ``eval/kalman_quasistatic.py``:

- :func:`generate_series`: a 100+-epoch series, one base scan moved by a
  random walk of small rigid transforms with fresh noise each epoch, and
  its ``defined_transformations.txt``; the same base and arguments write
  the same bytes as ``eval/scale_demo.generate_series``;
- :func:`scale_config`: scale_demo's configuration (res 0.005, SV 0.05,
  DTinit 0.05, DTmin 0.004, 4-digit timestamps, Kalman);
- :func:`run_fleet`: an epoch fleet, W concurrent ``4d`` shard processes
  over one output folder, each on its own share of the host's cores and on
  a card (``cuda:i mod count``: on one card all share it), then one
  ``--resume`` pass that finalises;
- :func:`generate_quasistatic`, :func:`quasistatic_config`,
  :func:`run_quasistatic` and :func:`quasistatic_report`: the static series
  where the Kalman smoother must pay (epochs of one surface, identity
  truth, direct mode).

Everything runs on the card unless the caller names the CPU:

    python -m piecewise_icp_torch.utils.scale series --workdir DIR
        [--epochs 101] [--n-side 378]
    python -m piecewise_icp_torch.utils.scale fleet --workdir DIR
        [--epochs 101] [--workers 1 2 4] [--device cuda] [--n-side 378]
        [--res 0.005]
    python -m piecewise_icp_torch.utils.scale quasistatic --workdir DIR
        [--epochs 12] [--device cuda] [--n-side 378] [--res 0.005]

On the CPU, a smaller base needs a coarser resolution: ``--device cpu
--n-side 60 --res 0.022`` (SV is ten times the resolution).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..config import PiecewiseICPConfig
from ..io import formats, read_pcd, scan_epoch_folder, write_pcd
from ..ops.preprocess import voxel_downsample
from ..ops.transform import (apply_transform_np, matrix_to_params_gon,
                             params_to_matrix)
from .synth import terrain_cloud

# the repository root: ``python -m piecewise_icp_torch`` resolves from there
ROOT = pathlib.Path(__file__).resolve().parents[2]

# the tables a finalised campaign writes that depend only on the pairs (so
# every fleet width writes them byte for byte alike); RegPairFile.txt is
# adaptive-only and phase_timings.jsonl holds timings
FLEET_TABLES = ("TransMatrices.txt", "TransParameters.txt",
                "TransMatrices_toRef.txt", "TransParameters_toRef.txt",
                "TransPara_AbsError.txt", "TransMatrices_toRef_smoothed.txt",
                "TransParameters_toRef_smoothed.txt",
                "TransPara_AbsError_smoothed.txt")


def default_base(seed: int = 0) -> np.ndarray:
    """The series' base scan: a 142,884-point terrain epoch (``n_side=378``
    over 2 m, 5 mm spacing), the size of the reference's synthetic
    ``Epoch_001`` (142,525 points)."""
    return terrain_cloud(np.random.default_rng(seed), n_side=378,
                         extent=2.0)


def generate_series(out_dir: str, n_epochs: int, base: np.ndarray,
                    seed: int = 0, noise: float = 1.5e-3,
                    downsample: float = 0.0, digits: int = 4) -> str:
    """Write ``scans/Epoch_0001..N.pcd`` and ``defined_transformations.txt``
    into ``out_dir``; return the scan folder.

    Epoch k is ``base`` with fresh noise (std ``noise`` a coordinate), moved
    by the inverse of the cumulative ground truth G_k (a random walk of
    about 30 mgon and 4 mm a step), so that registering epoch k onto the
    reference recovers G_k.  ``downsample`` > 0 voxel-thins the base
    first."""
    scans = os.path.join(out_dir, "scans")
    os.makedirs(scans, exist_ok=True)
    base = np.asarray(base, dtype=np.float32)
    if downsample > 0:
        base = voxel_downsample(base, downsample)
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(1, n_epochs):
        step = params_to_matrix(np.concatenate([
            rng.normal(scale=5e-4, size=3),
            rng.normal(scale=4e-3, size=3)]))
        gt.append(gt[-1] @ step)
    lines = []
    for k in range(n_epochs):
        pts = base + rng.normal(scale=noise, size=base.shape).astype(
            np.float32)
        moved = apply_transform_np(pts.astype(np.float64),
                                   np.linalg.inv(gt[k])).astype(np.float32)
        write_pcd(os.path.join(scans, f"Epoch_{k + 1:0{digits}d}.pcd"),
                  moved)
        lines.append(str(k + 1))
        for row in gt[k]:
            lines.append(" ".join(f"{v:.12f}" for v in row))
    with open(os.path.join(out_dir, "defined_transformations.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return scans


def scale_config(scans: str, out_dir: str,
                 **overrides) -> PiecewiseICPConfig:
    """scale_demo's configuration of the series (``eval/scale_demo.py``)."""
    kw = dict(path1=scans, path2=out_dir,
              set_res_svsize=True, res1=0.005, res2=0.005,
              svsize1=0.05, svsize2=0.05,
              set_dtinit=True, dt_init=0.05, dt_min=0.004,
              epoch_digits=4, kalman_enabled=True)
    kw.update(overrides)
    return PiecewiseICPConfig(**kw)


def table_digests(out_dir: str) -> dict:
    """The SHA-256 (first 16 hex digits) of each of :data:`FLEET_TABLES`."""
    return {name: hashlib.sha256(
        pathlib.Path(out_dir, name).read_bytes()).hexdigest()[:16]
        for name in FLEET_TABLES}


def pair_residuals_mm(out_dir: str, scans: str, ground_truth: str,
                      n_pairs: int, epoch_digits: int = 4) -> np.ndarray:
    """[n_pairs, 2] mean and max displacement (mm) that each fixed-interval
    pair's transform T (epoch k+1 onto epoch k, ``TransMatrices.txt``)
    leaves against the relative truth ``G_k^-1 G_k+1``, over epoch k+1's
    points: |T p - G_k^-1 G_k+1 p|."""
    files, _ = scan_epoch_folder(scans, digits=epoch_digits)
    _, gt = formats.read_ground_truth_transforms(ground_truth)
    _, mats, _ = formats.read_trans_matrices(
        os.path.join(out_dir, "TransMatrices.txt"), n_pairs)
    out = np.empty((n_pairs, 2))
    for k, tm in enumerate(mats):
        p = read_pcd(files[k + 1]).astype(np.float64)
        truth = np.linalg.inv(gt[k]) @ gt[k + 1]
        d = np.linalg.norm(apply_transform_np(p, tm)
                           - apply_transform_np(p, truth), axis=1)
        out[k] = 1e3 * d.mean(), 1e3 * d.max()
    return out


# ---------------------------------------------------------------------------
# the epoch fleet (eval/fleet_demo.py)
# ---------------------------------------------------------------------------

def _worker(report: str, threads: int, argv: list) -> int:
    """One process of the fleet: the ``4d`` command line (``argv``) on
    ``threads`` intra-op threads; writes its exit code, kernel launches,
    plain versions run on the card, threads, CPU seconds and the time it
    was entered (after the interpreter and the package, torch included,
    were loaded) to ``report`` at exit."""
    entered = time.time()
    import resource

    import torch

    from .. import __main__ as cli
    from ..ops import _cuda

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = cli.main(argv)
    finally:
        use = resource.getrusage(resource.RUSAGE_SELF)
        with open(report, "w") as f:
            json.dump({"rc": rc, "entered": entered,
                       "wall_s": time.perf_counter() - t0,
                       "cpu_s": use.ru_utime + use.ru_stime,
                       "threads": torch.get_num_threads(),
                       "launches": dict(_cuda.LAUNCHES),
                       "plain_on_cuda": dict(_cuda.PLAIN_ON_CUDA)}, f)
    return rc


def _worker_cmd(report: str, threads: int, argv: list) -> list:
    return [sys.executable, "-m", "piecewise_icp_torch.utils.scale",
            "worker", report, str(threads), *argv]


def _worker_env(threads: int) -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(threads)
    env["OPENBLAS_NUM_THREADS"] = str(threads)
    return env


def _log_tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_fleet(conf: PiecewiseICPConfig, out_dir: str, epochs: int,
              mode: int, workers: int, device: str = "cuda",
              threads: int | None = None, kalman: bool = True,
              epoch_digits: int = 4, ground_truth: str | None = None,
              baseline_s: float | None = None,
              timeout: float | None = None) -> dict:
    """Run the campaign of ``conf`` (its scans in ``conf.path1``) as an epoch
    fleet of ``workers`` concurrent processes into a fresh ``out_dir``, then
    finalise it once; return the record of ``eval/fleet_demo.run_fleet``.

    Each worker is ``python -m piecewise_icp_torch 4d --shards W --shard i
    --no-finalize`` (with ``--kalman`` and ``--epoch-digits``) on
    ``cuda:(i mod device_count)`` (or ``cpu``), with ``threads`` intra-op
    threads (default: the cores of this process's affinity over W).  The
    workers read ``conf`` from the reference's 11-line file, written to
    ``out_dir/fleet/config_4d.txt`` with the worker logs and reports; a
    ``conf`` that the file and those flags cannot carry raises.  On
    ``cuda`` the kernel library is built and loaded here first, so the
    workers find it built.

    Raises ``RuntimeError`` when a worker or the finalise exits non-zero,
    when the pairs' epoch timestamps repeat (``epoch_digits`` too few for
    the file names), or after ``timeout`` seconds (every process it started
    is stopped).  ``baseline_s``, the pairs wall of one worker, adds
    ``speedup_vs_1`` and ``efficiency_pct``."""
    import torch

    from ..device import resolve_device

    resolve_device(device)
    cores = len(os.sched_getaffinity(0))
    threads = threads or max(1, cores // workers)
    out_dir = os.path.join(os.path.abspath(out_dir), "")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    fleet_dir = os.path.join(out_dir, "fleet")
    os.makedirs(fleet_dir)
    conf_file = os.path.join(fleet_dir, "config_4d.txt")
    dataclasses.replace(conf, path2=out_dir).to_reference_file(conf_file)
    want = dataclasses.replace(conf, path2=out_dir, kalman_enabled=kalman,
                               epoch_digits=epoch_digits)
    got = PiecewiseICPConfig.from_reference_file(
        conf_file, kalman_enabled=kalman, epoch_digits=epoch_digits,
        epoch_prefix=conf.epoch_prefix)
    lost = [f.name for f in dataclasses.fields(want)
            if getattr(want, f.name) != getattr(got, f.name)]
    if lost:
        raise ValueError(f"the fleet's workers cannot carry {lost} (the "
                         "reference's config file and the 4d flags do not)")

    if device.startswith("cuda"):
        from ..ops import _cuda
        _cuda.lib()
        devices = [f"cuda:{i % torch.cuda.device_count()}"
                   for i in range(workers)]
    else:
        devices = [device] * workers
    argv = ["4d", "--config", conf_file, "--epochs", str(epochs),
            "--mode", str(mode), "--epoch-digits", str(epoch_digits),
            "--epoch-prefix", conf.epoch_prefix, "--shards", str(workers)]
    if kalman:
        argv.append("--kalman")
    if ground_truth:
        argv += ["--ground-truth", ground_truth]
    env = _worker_env(threads)

    def path(name: str) -> str:
        return os.path.join(fleet_dir, name)

    procs, logs = [], []
    done: list = [None] * workers
    started = time.time()
    t0 = time.perf_counter()
    try:
        for i in range(workers):
            logs.append(open(path(f"worker_{i}.log"), "w"))
            procs.append(subprocess.Popen(
                _worker_cmd(path(f"worker_{i}.json"), threads,
                            argv + ["--shard", str(i), "--no-finalize",
                                    "--device", devices[i]]),
                env=env, cwd=ROOT, stdout=logs[i],
                stderr=subprocess.STDOUT))
        while None in done:
            for i, p in enumerate(procs):
                if done[i] is None and p.poll() is not None:
                    done[i] = time.perf_counter() - t0
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"fleet of {workers}: workers still "
                                   f"running after {timeout} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    pairs_wall = time.perf_counter() - t0
    finished = time.time()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        bad = next(i for i, rc in enumerate(rcs) if rc)
        raise RuntimeError(
            f"fleet worker failed (rcs={rcs}); worker {bad}'s log ends:\n"
            + _log_tail(path(f"worker_{bad}.log")))
    reports = [json.loads(pathlib.Path(path(f"worker_{i}.json")).read_text())
               for i in range(workers)]

    # the epoch timestamps must be distinct, or every table row and report
    # of the campaign carries the same one
    stamps = []
    for f in sorted(glob.glob(os.path.join(out_dir, "pairs", "*.npz"))):
        with np.load(f) as d:
            stamps.append(int(d["ts"]))
    if len(set(stamps)) != len(stamps):
        raise RuntimeError(
            f"the pairs' epoch timestamps repeat ({stamps[:8]}...): "
            f"{epoch_digits} digits do not fit the scan file names")

    t1 = time.perf_counter()
    with open(path("finalize.log"), "w") as log:
        fin = subprocess.run(
            _worker_cmd(path("finalize.json"), cores,
                        argv + ["--shard", "0", "--resume",
                                "--device", devices[0]]),
            env=_worker_env(cores), cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, timeout=timeout)
    finalize_wall = time.perf_counter() - t1
    if fin.returncode:
        raise RuntimeError(f"finalise failed (rc {fin.returncode}):\n"
                           + _log_tail(path("finalize.log")))
    rec = {"workers": workers, "devices": devices, "cores": cores,
           "threads_per_worker": threads, "pairs": len(stamps),
           "pairs_wall_s": pairs_wall, "per_worker_done_s": done,
           "finalize_wall_s": finalize_wall, "worker_rcs": rcs,
           "epochs_per_s": len(stamps) / pairs_wall,
           "worker_threads": [r["threads"] for r in reports],
           "worker_cpu_s": [r["cpu_s"] for r in reports],
           # spawn to the worker's entry: the interpreter and the imports
           "worker_startup_s": [r["entered"] - started for r in reports],
           # the share of the cores' time the workers kept busy
           "host_busy_pct": 100 * sum(r["cpu_s"] for r in reports)
           / (pairs_wall * cores),
           "launches": [r["launches"] for r in reports],
           "plain_on_cuda": [r["plain_on_cuda"] for r in reports],
           "window": [started, finished]}
    if baseline_s:
        rec["speedup_vs_1"] = baseline_s / pairs_wall
        rec["efficiency_pct"] = 100 * rec["speedup_vs_1"] / workers
    return rec


# ---------------------------------------------------------------------------
# the quasi-static campaign (eval/kalman_quasistatic.py)
# ---------------------------------------------------------------------------

def generate_quasistatic(workdir: str, epochs: int, base: np.ndarray,
                         noise: float = 5e-4) -> str:
    """``epochs`` independent noise realisations of ``base`` (no motion) as
    ``scans/Epoch_001..``, identity ground truth; return the scan folder."""
    scans = os.path.join(workdir, "scans")
    os.makedirs(scans, exist_ok=True)
    base = np.asarray(base).astype(np.float64)
    rng = np.random.default_rng(7)
    for k in range(epochs):
        pts = base + rng.normal(scale=noise, size=base.shape)
        write_pcd(os.path.join(scans, f"Epoch_{k + 1:03d}.pcd"),
                  pts.astype(np.float32))
    with open(os.path.join(workdir, "defined_transformations.txt"),
              "w") as f:
        # the reference's layout: the epoch number on its own line, then
        # the 4x4 row-major matrix
        for k in range(epochs):
            f.write(f"{k + 1}\n")
            for row in np.eye(4):
                f.write(" ".join(f"{v:.10f}" for v in row) + " \n")
    return scans


def quasistatic_config(scans: str, out_dir: str,
                       **overrides) -> PiecewiseICPConfig:
    """The quasi-static campaign's configuration
    (``eval/kalman_quasistatic.py``)."""
    kw = dict(path1=scans, path2=out_dir,
              set_res_svsize=True, res1=0.005, res2=0.005,
              svsize1=0.05, svsize2=0.05, set_dtinit=True,
              dt_init=0.05, dt_min=0.004, kalman_enabled=True)
    kw.update(overrides)
    return PiecewiseICPConfig(**kw)


def quasistatic_report(out_dir: str, epochs: int) -> dict:
    """The numbers of ``eval/kalman_quasistatic.py`` (unrounded) from a
    finished direct-mode campaign in ``out_dir``: raw and smoothed mean
    errors, their ratios, the common-mode bias (every epoch registers onto
    the same noisy epoch 1, an error no smoother removes) and the
    reduction of the independent, per-epoch component (its std)."""
    raw = formats.read_abs_errors(
        os.path.join(out_dir, "TransPara_AbsError.txt"))
    sm = formats.read_abs_errors(
        os.path.join(out_dir, "TransPara_AbsError_smoothed.txt"))

    def signed(fname: str) -> np.ndarray:
        _, mats, _ = formats.read_trans_matrices(
            os.path.join(out_dir, fname), epochs - 1)
        return np.stack([matrix_to_params_gon(m) for m in mats])

    z_raw = signed("TransMatrices_toRef.txt")        # truth = 0
    z_sm = signed("TransMatrices_toRef_smoothed.txt")
    return {
        "epochs": epochs,
        "raw_mean_rot_mgon": raw[:, :3].mean(0).tolist(),
        "raw_mean_trans_mm": raw[:, 3:].mean(0).tolist(),
        "smoothed_mean_rot_mgon": sm[:, :3].mean(0).tolist(),
        "smoothed_mean_trans_mm": sm[:, 3:].mean(0).tolist(),
        "rot_reduction": float(raw[:, :3].mean()
                               / max(sm[:, :3].mean(), 1e-12)),
        "trans_reduction": float(raw[:, 3:].mean()
                                 / max(sm[:, 3:].mean(), 1e-12)),
        "common_mode_bias_rot_mgon": (z_raw.mean(0)[:3] * 1000).tolist(),
        "independent_component_reduction": float(
            z_raw.std(axis=0).mean() / max(z_sm.std(axis=0).mean(), 1e-15)),
    }


def run_quasistatic(workdir: str, epochs: int = 12,
                    base: np.ndarray | None = None,
                    device: str = "cuda", **overrides) -> dict:
    """Generate the quasi-static series of ``base`` (default:
    :func:`default_base`) into ``workdir``, run the direct-mode Kalman
    campaign of :func:`quasistatic_config` (with ``overrides``) in this
    process on ``device`` and return :func:`quasistatic_report` with
    ``ok``."""
    from ..models.four_d import run_4d

    scans = generate_quasistatic(
        workdir, epochs, default_base() if base is None else base)
    out_dir = os.path.join(workdir, "results", "")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    ok = run_4d(quasistatic_config(scans, out_dir, **overrides), 0,
                epochs, 0,
                overlap_thd=0.75,
                ground_truth=os.path.join(workdir,
                                          "defined_transformations.txt"),
                device=device)
    return {"ok": bool(ok), **quasistatic_report(out_dir, epochs)}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def _base(n_side: int) -> np.ndarray:
    return terrain_cloud(np.random.default_rng(0), n_side=n_side, extent=2.0)


def _series(workdir: str, epochs: int, n_side: int) -> str:
    """The series in ``workdir`` (generated when it holds fewer epochs)."""
    scans = os.path.join(workdir, "scans")
    if os.path.isdir(scans) and len(os.listdir(scans)) >= epochs:
        return scans
    return generate_series(workdir, epochs, _base(n_side))


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["worker"]:          # one process of run_fleet
        return _worker(argv[1], int(argv[2]), argv[3:])
    ap = argparse.ArgumentParser(
        prog="python -m piecewise_icp_torch.utils.scale",
        description="BASELINE configuration 5: the scaled 4D campaign as "
        "an epoch fleet, and the quasi-static Kalman campaign")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_series = sub.add_parser("series", help="write the series")
    p_fleet = sub.add_parser("fleet", help="run the series as fleets of "
                             "1, 2, 4 ... workers")
    p_quasi = sub.add_parser("quasistatic", help="the quasi-static Kalman "
                             "campaign")
    for p, epochs in ((p_series, 101), (p_fleet, 101), (p_quasi, 12)):
        p.add_argument("--workdir", default=os.path.join(
            tempfile.gettempdir(), "pwicp_scale"))
        p.add_argument("--epochs", type=int, default=epochs)
    for p in (p_series, p_fleet, p_quasi):
        p.add_argument("--n-side", type=int, default=378,
                       help="the base scan's side (378: 142,884 points)")
    for p in (p_fleet, p_quasi):
        p.add_argument("--res", type=float, default=0.005,
                       help="resolution (SV 10 times it); a smaller base "
                       "needs a coarser one: 0.022 at --n-side 60")
    p_fleet.add_argument("--workers", type=int, nargs="+",
                         default=[1, 2, 4])
    p_fleet.add_argument("--mode", type=int, default=1)
    for p in (p_fleet, p_quasi):
        p.add_argument("--device", default="cuda", help="cuda (default) "
                       "or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    if args.cmd == "series":
        print(_series(args.workdir, args.epochs, args.n_side))
        return 0
    res = dict(res1=args.res, res2=args.res, svsize1=10 * args.res,
               svsize2=10 * args.res)
    if args.cmd == "quasistatic":
        print(json.dumps(run_quasistatic(args.workdir, args.epochs,
                                         base=_base(args.n_side),
                                         device=args.device, **res)))
        return 0
    scans = _series(args.workdir, args.epochs, args.n_side)
    gt = os.path.join(args.workdir, "defined_transformations.txt")
    runs, t1 = [], None
    for w in args.workers:
        out = os.path.join(args.workdir, f"out_{w}w")
        r = run_fleet(scale_config(scans, out, **res), out, args.epochs,
                      args.mode, w, device=args.device, ground_truth=gt,
                      baseline_s=t1 if w > 1 else None)
        if w == 1:
            t1 = r["pairs_wall_s"]
            r.update(speedup_vs_1=1.0, efficiency_pct=100.0)
        r["tables"] = table_digests(out)
        runs.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"epochs": args.epochs, "mode": args.mode,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
