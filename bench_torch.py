#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one GPU (the counterpart of the
JAX package's ``bench.py``).

    python3 bench_torch.py [--seed 0] [--device cuda] [--n-side 378]
                           [--res 0.005] [--warm-reps 5] [--reps 3]

Registers the bench pair (``utils/synth.make_pair``: two 142,884-point
terrain epochs, the second moved by a known transform) with ``bench.py``'s
configuration (res 0.005 m, SV 0.05 m, DTinit 0.05 m, DTmin 0.004 m: the
port's defaults) and measures, on the card:

* ``build_s``: the kernel library's build (``ops/_cuda.py``), set-up and
  not pair time, null when a build of these sources already existed;
* ``cold_fresh_s``: a fresh process with the library built (imports, CUDA
  context, library load, first pair; skipped where
  ``PWICP_BENCH_SKIP_COLD`` is set), then ``cold_s``, this process's first
  pair;
* ``warm_s``: the median of ``--warm-reps`` pairs after one more, the
  middle repeat's phases and kernel launches;
* ``campaign_serial_epoch_s``: ``prepare_target`` of an epoch and its
  registration against a prepared target, median of ``--reps``;
* ``campaign_epoch_s``: ``run_4d`` over a 6-epoch series written as PCD
  files (5 pairs, fixed interval), wall over pairs, median of ``--reps``
  after a warm run;
* the pair's accuracy under the symmetric objective;
* ``nn_kernels``: K1, K2, K5 and K6 on the voxelised first epoch, each
  the median of 5 calls between CUDA events after a warm-up, against its
  bound on the card, and one call of ``torch.cdist`` (direct mode) and
  ``amin`` for the brute search, and ``topk`` for the brute k-NN;
* ``icp_iters_per_s``: 32 chained ``point_to_plane_icp`` solves on the
  pair's patch centroids.

Every time on the card ends in ``torch.cuda.synchronize()``.  Prints ONE
JSON line (``metric`` epochs/s = 1 / ``warm_s``, with the spread of every
repeated time under ``variance`` and the card under ``device``).  Runs on
the card unless ``--device cpu`` is given (for the tests: the kernels'
plain versions, the host clock, no bound shares); with no card visible and
no ``--device cpu`` it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# the bench pair: chip_smoke.py's smoke pair (142,884 points an epoch at the
# reference's ~5 mm spacing), and the campaign: a 6-epoch series of the same
# surface drifting 2 cm a step, registered at a fixed interval of 1
N_SIDE = 378
EXTENT = 2.0
PARAMS = [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005]
RES = 0.005
CAMPAIGN_EPOCHS = 6
CAMPAIGN_TREND = (0.0, 0.0, 0.02)
# the inner-ICP microbenchmark of bench.py: chained solves of up to 100
# iterations with both stopping tolerances at 0, on the pair's patch
# centroids shifted by this offset (m)
ICP_CHAIN = 32
ICP_SHIFT = (2e-3, -1e-3, 1.5e-3)
KERNEL_REPS = 5
# K6 at the unified SOR rescue's largest shape: its budget of unresolved
# queries (ops/preprocess.py:_SOR_RESCUE), drawn at random from the epoch,
# against the epoch, k + 1 slots
KNN_RESCUE = 4096
SOR_K = 14

# the keys of the line (dotted for nested ones); chip_smoke.py's bench phase
# fails on a line without one of them
LINE_KEYS = (
    "metric", "value", "unit", "warm_s", "cold_s", "cold_fresh_s", "build_s",
    "campaign_epoch_s", "campaign_epochs_per_s", "campaign_serial_epoch_s",
    "campaign_note", "campaign_errors.rot_max_mgon",
    "campaign_errors.trans_max_mm", "icp_iters_per_s", "icp_metric_note",
    "icp_iters_warm_pair", "variance.warm_s", "variance.campaign_epoch_s",
    "variance.campaign_serial_epoch_s", "variance.icp_iters_per_s",
    "variance.note", "rot_err_mgon", "trans_err_mm", "residual_mean_mm",
    "residual_max_mm", "symmetric_icp.rot_err_mgon",
    "symmetric_icp.trans_err_mm", "nn_kernels.n_points", "nn_kernels.clock",
    "nn_kernels.launch_floor_ms", "nn_kernels.brute_kernel_ms",
    "nn_kernels.library_brute_ms", "nn_kernels.range_nn1_ms",
    "nn_kernels.range_nn1_sorted_ms", "nn_kernels.knn_sorted_ms",
    "nn_kernels.knn_brute_ms", "nn_kernels.library_knn_ms",
    "nn_kernels.launches", "nn_kernels.roofline.model",
    "nn_kernels.roofline.nn1_brute", "nn_kernels.roofline.range_nn1",
    "nn_kernels.roofline.range_nn1_sorted",
    "nn_kernels.roofline.knn_sorted", "nn_kernels.roofline.knn_brute",
    "nn_kernels.note", "phases",
    "fine_phases", "launches", "plain_on_cuda", "trans_mat", "n_points",
    "seed", "device.name", "device.power_limit", "device.count")


def missing_keys(line: dict) -> list:
    """The keys of :data:`LINE_KEYS` that ``line`` lacks."""
    missing = []
    for key in LINE_KEYS:
        node = line
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                missing.append(key)
                break
            node = node[part]
    return missing


def log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def bench_config(res: float = RES):
    """``bench.py``'s configuration at resolution ``res`` (SV 10 x res)."""
    from piecewise_icp_torch.config import PiecewiseICPConfig

    return PiecewiseICPConfig(
        set_res_svsize=True, res1=res, res2=res, svsize1=10 * res,
        svsize2=10 * res, set_dtinit=True, dt_init=0.05, dt_min=0.004)


def bench_pair(seed: int, n_side: int = N_SIDE):
    """(cloud1, cloud2, T_true): cloud2 is an independent scan moved by
    T_true, so the registration estimates T_true's inverse."""
    from piecewise_icp_torch.utils.synth import make_pair

    return make_pair(np.random.default_rng(seed), PARAMS, n_side=n_side,
                     extent=EXTENT)


def pose_errors(t_est: np.ndarray, t_true: np.ndarray):
    """(rotation mgon, translation mm): the largest parameter difference of
    ``bench.py`` between the estimate and the inverse of ``t_true``."""
    from piecewise_icp_torch.ops.transform import matrix_to_params_gon

    err = matrix_to_params_gon(t_est) \
        - matrix_to_params_gon(np.linalg.inv(t_true))
    return (float(np.abs(err[:3]).max() * 1000),
            float(np.abs(err[3:]).max() * 1000))


def _spread(xs) -> list:
    """[min, median, max]."""
    return [min(xs), statistics.median(xs), max(xs)]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fresh_cold_child(t0: float, pair_npz: str, res: float,
                     device: str) -> None:
    """The body of the fresh process: import the port, register the pair
    in ``pair_npz``, print the seconds since ``t0`` (taken before any
    import)."""
    import torch

    from piecewise_icp_torch.models.pairwise import register_pair

    cfg = bench_config(res)
    with np.load(pair_npz) as z:
        register_pair(z["c1"], z["c2"], cfg, sor_mult=cfg.sor_std_mult_4d,
                      device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    print("COLD_FRESH_S", time.perf_counter() - t0, flush=True)


def measure_fresh_cold(c1: np.ndarray, c2: np.ndarray, res: float,
                       device: str) -> "float | None":
    """A fresh process's first pair with the kernel library already built;
    None where ``PWICP_BENCH_SKIP_COLD`` is set."""
    if os.environ.get("PWICP_BENCH_SKIP_COLD"):
        return None
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "pair.npz")
        np.savez(npz, c1=c1, c2=c2)
        prog = ("import time; t0 = time.perf_counter()\n"
                "import bench_torch\n"
                f"bench_torch.fresh_cold_child(t0, {npz!r}, {res!r}, "
                f"{device!r})\n")
        out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("COLD_FRESH_S"):
            return float(line.split()[1])
    raise RuntimeError(f"the fresh-process pair failed (exit "
                       f"{out.returncode}):\n{out.stderr[-4000:]}")


def _warm_pairs(pts1, pts2, cfg, reps: int, dev):
    """One untimed pair, then ``reps`` timed ones: (times, the middle
    repeat's result, its GLOBAL_TIMER summary, its launches and plain
    versions on CUDA)."""
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d, device=dev)
    times, runs = [], []
    for _ in range(reps):
        GLOBAL_TIMER.records.clear()
        _cuda.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d,
                            device=dev)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        runs.append((res, GLOBAL_TIMER.summary(), dict(_cuda.LAUNCHES),
                     dict(_cuda.PLAIN_ON_CUDA)))
    return times, runs[int(np.argsort(times)[len(times) // 2])]


def _serial_campaign(pts1, pts2, cfg, reps: int, dev) -> list:
    """``prepare_target`` of the source epoch and its registration against
    the prepared target (the warm pairs before ran the same code)."""
    from piecewise_icp_torch.models.pairwise import (prepare_target,
                                                     register_pair)

    mult = cfg.sor_std_mult_4d
    ts1 = prepare_target(pts1, cfg, mult, device=dev)
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        ss2 = prepare_target(pts2, cfg, mult, device=dev)
        register_pair(None, None, cfg, sor_mult=mult, target_state=ts1,
                      source_state=ss2, device=dev)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def _run_4d_campaign(seed: int, n_side: int, cfg, reps: int, dev):
    """``run_4d`` over the 6-epoch series (5 pairs, fixed interval 1): s a
    pair of ``reps`` runs after a warm one, and the chained errors of the
    last (max rotation mgon, max translation mm)."""
    from piecewise_icp_torch.io import formats, write_pcd
    from piecewise_icp_torch.models.four_d import run_4d
    from piecewise_icp_torch.utils.synth import make_series, \
        write_ground_truth

    epochs, gt = make_series(np.random.default_rng(seed + 2),
                             CAMPAIGN_EPOCHS, trend=CAMPAIGN_TREND,
                             n_side=n_side, extent=EXTENT)
    pairs = CAMPAIGN_EPOCHS - 1
    with tempfile.TemporaryDirectory(prefix="pwicp_bench4d_") as tmp:
        tmp = pathlib.Path(tmp)
        scans = tmp / "scans"
        scans.mkdir()
        for k, e in enumerate(epochs):
            write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
        write_ground_truth(tmp / "defined_transformations.txt", gt)
        times = []
        for k in range(reps + 1):
            out = tmp / f"out_{k}"
            out.mkdir()
            cfg4d = dataclasses.replace(cfg, path1=str(scans),
                                        path2=str(out) + "/")
            _sync(dev)
            t0 = time.perf_counter()
            if not run_4d(cfg4d, 0, CAMPAIGN_EPOCHS, 1, device=dev):
                raise RuntimeError("run_4d returned False")
            _sync(dev)
            if k:
                times.append((time.perf_counter() - t0) / pairs)
        errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
    if errors.shape != (pairs, 6) or not np.isfinite(errors).all():
        raise RuntimeError(f"run_4d: bad error table {errors.shape}")
    return times, {"rot_max_mgon": float(errors[:, :3].max()),
                   "trans_max_mm": float(errors[:, 3:].max())}


def launch_floor_ms(dev, reps: int = 20) -> float:
    """One one-element op and a synchronize, host clock, median."""
    import torch

    x = torch.zeros(1, device=dev)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        x.add_(1.0)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def library_brute(q, t):
    """The brute 1-NN distance through the library: ``torch.cdist`` in its
    direct mode (coordinate differences, not the matmul identity), then
    ``amin``, over query chunks that fit the card.  A yardstick only."""
    import torch

    from piecewise_icp_torch.ops.nn_cuda import _chunk_rows

    rows = _chunk_rows(t.shape[0], t.device)
    return torch.cat([
        torch.cdist(q[s:s + rows], t,
                    compute_mode="donot_use_mm_for_euclid_dist").amin(dim=1)
        for s in range(0, q.shape[0], rows)])


def library_knn(q, t, k: int):
    """The k smallest distances through the library: ``torch.cdist`` in its
    direct mode, then ``topk``, over query chunks that fit the card.  A
    yardstick only."""
    import torch

    from piecewise_icp_torch.ops.nn_cuda import _chunk_rows

    rows = _chunk_rows(t.shape[0], t.device)
    return torch.cat([
        torch.cdist(q[s:s + rows], t,
                    compute_mode="donot_use_mm_for_euclid_dist").topk(
                        k, dim=1, largest=False).values
        for s in range(0, q.shape[0], rows)])


def nn_kernels(pts1: np.ndarray, res: float, dev) -> dict:
    """K5, K1, K2 and K6 at ``bench.py``'s shapes on the voxelised epoch:
    the brute 1-NN of every point against all (n x n), the grid 1-NN of
    every point on its own grid of 4 x res in file order (the kernel's
    wrapper) and cell-sorted (the stage-1 path's public call), the
    self-join with k = 2 (the nearest other point), and the SOR rescue's
    brute k-NN at the unified path's largest shape (``KNN_RESCUE`` queries
    against all, k + 1 = 15, the SOR-mean epilogue); each time beside its
    bound.  K6's queries are a random sample of the epoch, not the sparse
    points the rescue meets (``chip_smoke.py``'s rockfall phase times K6 on
    those): its list takes inserts at another rate there."""
    import torch

    from piecewise_icp_torch.models.piecewise_icp import _cell_order
    from piecewise_icp_torch.ops import _cuda, nn_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
    from piecewise_icp_torch.ops.preprocess import voxel_downsample
    from piecewise_icp_torch.utils.measure import (knn_brute_bound,
                                                   knn_sorted_bound,
                                                   nn1_brute_bound,
                                                   range_nn1_bound, time_ms,
                                                   window_pairs)

    down = voxel_downsample(pts1, res)
    n = down.shape[0]
    index = build_grid(down, 4 * res)
    grid = CellGrid.from_index(index, dev)
    q = torch.from_numpy(down).to(dev)
    q_sorted = torch.from_numpy(down[_cell_order(down, index)]).to(dev)
    all_q = torch.ones(n, dtype=torch.bool, device=dev)
    q_rescue = q[torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        n, min(KNN_RESCUE, n), replace=False))).to(dev)]

    def ms(fn):
        return time_ms(fn, reps=KERNEL_REPS, device=dev.type)

    _cuda.reset_counts()
    times = {
        "brute_kernel_ms": ms(lambda: nn_cuda.nn1_brute(q, q)),
        "range_nn1_ms": ms(lambda: nn_cuda.range_nn1_counted(q, None, grid)),
        "range_nn1_sorted_ms": ms(
            lambda: nn_cuda.range_nn1(q_sorted, None, grid)),
        "knn_sorted_ms": ms(lambda: nn_cuda.knn_sorted(grid, all_q, 2)),
        "knn_brute_ms": ms(lambda: nn_cuda.knn_brute(
            q_rescue, q, SOR_K + 1, epilogue="sor_mean")),
    }
    launches = {k: int(_cuda.LAUNCHES.get(k, 0))
                for k in ("range_nn1", "knn_sorted", "nn1_brute",
                          "knn_brute")}
    # one call, no warm-up: the direct mode meets the n x n pairs about
    # 3,000 times slower than K5 (20.7-20.8 s at 129,097 x 129,097 on an
    # NVIDIA H100 80GB HBM3 at 700 W), and K5's launches have warmed the card
    times["library_brute_ms"] = time_ms(lambda: library_brute(q, q), reps=1,
                                        device=dev.type, warmup=False)
    times["library_knn_ms"] = time_ms(
        lambda: library_knn(q_rescue, q, SOR_K + 1), reps=1,
        device=dev.type, warmup=False)
    nr = q_rescue.shape[0]
    bounds = {
        "nn1_brute": (nn1_brute_bound(n, n, n * n, False, False),
                      times["brute_kernel_ms"]),
        "range_nn1": (range_nn1_bound(grid, n, False, window_pairs(grid, q)),
                      times["range_nn1_ms"]),
        "range_nn1_sorted": (range_nn1_bound(
            grid, n, False, window_pairs(grid, q_sorted)),
            times["range_nn1_sorted_ms"]),
        "knn_sorted": (knn_sorted_bound(grid, 2, window_pairs(grid)),
                       times["knn_sorted_ms"]),
        "knn_brute": (knn_brute_bound(nr, n, nr * n, False, 1),
                      times["knn_brute_ms"]),
    }
    on_card = dev.type == "cuda"
    roofline = {"model": "NVIDIA H100 SXM data sheet: 3.35e12 B/s of "
                "device memory, 33.5e12 float32 lane instructions/s (67 "
                "TFLOP/s counts a fused multiply-add as two; the distance "
                "contract forbids fusing)"}
    for name, (b, t_ms) in bounds.items():
        roofline[name] = {
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            # a share of the card's bound only from a time on the card
            "share_pct": 100 * b["bound_ms"] / t_ms if on_card else None}
    return {
        "n_points": n,
        "clock": "cuda events" if on_card else "host clock (cpu: the "
                 "kernels' plain versions)",
        "launch_floor_ms": launch_floor_ms(dev),
        **times,
        "launches": launches,
        "roofline": roofline,
        "note": "grid_h = 4 x res; brute and library at n x n; "
                "library_brute_ms is ONE call of torch.cdist (direct mode) "
                "+ amin over query chunks, never on the port's path; "
                "knn_brute at the unified SOR rescue's largest shape "
                f"({nr} queries x n, k + 1 = {SOR_K + 1}; the queries a "
                "random sample of the epoch, not the rescue's sparse "
                "points), "
                "library_knn_ms ONE call of torch.cdist (direct mode) + "
                "topk there; "
                "bench.py's "
                "grid_xla_gather_ms has no counterpart: the XLA gather grid "
                "query is not ported (the CSR-walk kernels replace it)",
    }


def icp_rate(core, reps: int, dev) -> tuple:
    """Inner point-to-plane ICP iterations a second: ``ICP_CHAIN`` solves
    on the pair's patch centroids, the source shifted by ``ICP_SHIFT``, the
    host clock around the chain; each inner iteration ends in one host read,
    which the rate includes.  Returns (iterations/s of each of ``reps``
    chains after one untimed solve, iterations a chain)."""
    import torch

    from piecewise_icp_torch.models.icp import point_to_plane_icp

    f32 = dict(dtype=torch.float32, device=dev)
    p1, p2 = core.patches1, core.patches2
    ct1 = torch.as_tensor(p1.centroids, **f32)
    n1 = torch.as_tensor(p1.normals, **f32)
    ct2 = torch.as_tensor(p2.centroids + np.asarray(ICP_SHIFT, np.float32),
                          **f32)
    m1 = torch.ones(ct1.shape[0], dtype=torch.bool, device=dev)
    m2 = torch.ones(ct2.shape[0], dtype=torch.bool, device=dev)

    def solve():
        return point_to_plane_icp(ct1, n1, m1, ct2, m2, max_iterations=100,
                                  transformation_eps=0.0, fitness_eps=0.0)[1]

    solve()
    rates, iters = [], 0
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        iters = sum(solve() for _ in range(ICP_CHAIN))
        _sync(dev)
        rates.append(iters / (time.perf_counter() - t0))
    return rates, iters


def device_info(dev) -> dict:
    """The card's name and power limit (``nvidia-smi``) and the count of
    cards; for the CPU, the word ``cpu``."""
    import torch

    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 0}
    from piecewise_icp_torch.utils.measure import nvidia_smi_line

    name, _, limit = nvidia_smi_line().rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip(),
            "count": torch.cuda.device_count()}


def measure(seed: int = 0, device: str = "cuda", n_side: int = N_SIDE,
            res: float = RES, warm_reps: int = 5, reps: int = 3) -> dict:
    """Every measurement of the bench; returns the line as a dict."""
    import torch

    from piecewise_icp_torch.device import resolve_device
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.utils.measure import truth_mm

    dev = resolve_device(device)
    cfg = bench_config(res)
    pts1, pts2, t_true = bench_pair(seed, n_side)
    log(f"bench pair: {len(pts1)} + {len(pts2)} points (n_side {n_side}, "
        f"seed {seed}), res {res} m, on {dev}")

    build_s = None
    if dev.type == "cuda":
        _cuda.build()
        build_s = _cuda.build_seconds
        log("kernel library " + ("already built" if build_s is None
                                 else f"built in {build_s:.2f} s"))
    # before this process's first pair: the fresh one has the card alone
    cold_fresh = measure_fresh_cold(pts1, pts2, res, str(dev))
    log(f"fresh-process cold pair {cold_fresh} s")

    _sync(dev)
    t0 = time.perf_counter()
    register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d, device=dev)
    _sync(dev)
    cold = time.perf_counter() - t0
    warm_reps_s, (result, fine, launches, plain_on_cuda) = _warm_pairs(
        pts1, pts2, cfg, warm_reps, dev)
    warm = statistics.median(warm_reps_s)
    rot_err, trans_err = pose_errors(result.trans_mat, t_true)
    res_mean, res_max = truth_mm(result.trans_mat, t_true, pts2)
    log(f"cold {cold:.3f} s, warm {_spread(warm_reps_s)} s; {rot_err:.3f} "
        f"mgon, {trans_err:.4f} mm; residual {res_mean:.4f} / {res_max:.4f} "
        f"mm")

    serial = _serial_campaign(pts1, pts2, cfg, reps, dev)
    camp, camp_err = _run_4d_campaign(seed, n_side, cfg, reps, dev)
    log(f"serial {_spread(serial)} s/epoch, run_4d {_spread(camp)} s/pair, "
        f"errors {camp_err}")

    sym = register_pair(pts1, pts2,
                        dataclasses.replace(cfg, icp_variant="symmetric"),
                        sor_mult=cfg.sor_std_mult_4d, device=dev)
    sym_rot, sym_trans = pose_errors(sym.trans_mat, t_true)

    nn = nn_kernels(pts1, res, dev)
    log(f"nn kernels {json.dumps(nn)}")
    rates, icp_iters = icp_rate(result.core, reps, dev)

    camp_s = statistics.median(camp)
    return {
        "metric": "epochs/s",
        "value": 1.0 / warm,
        "unit": "epochs/s",
        "warm_s": warm,
        "campaign_epoch_s": camp_s,
        "campaign_epochs_per_s": 1.0 / camp_s,
        "campaign_serial_epoch_s": statistics.median(serial),
        "campaign_note": "campaign_epoch_s = run_4d wall / pairs over a "
                         f"{CAMPAIGN_EPOCHS}-epoch series written as PCD "
                         "files (epoch prep of pair k+1 overlapping pair k, "
                         "pair files, chaining and the tables included); "
                         "campaign_serial_epoch_s = prepare_target + "
                         "register_pair against a prepared target",
        "campaign_errors": camp_err,
        "build_s": build_s,
        "cold_s": cold,
        "cold_fresh_s": cold_fresh,
        "icp_iters_per_s": statistics.median(rates),
        "icp_metric_note": f"{icp_iters} inner iterations over "
                           f"{ICP_CHAIN} chained point_to_plane_icp solves "
                           "(max_iterations 100, eps 0), host clock; each "
                           "iteration's host read is part of the rate, "
                           "nothing subtracted",
        "icp_iters_warm_pair": int(result.core.total_icp_iters),
        "variance": {
            "warm_s": _spread(warm_reps_s),
            "campaign_epoch_s": _spread(camp),
            "campaign_serial_epoch_s": _spread(serial),
            "icp_iters_per_s": _spread(rates),
            "note": f"[min, median, max] over in-process repeats ("
                    f"{warm_reps} pairs, {reps} of the rest); headline "
                    "values are medians",
        },
        "rot_err_mgon": rot_err,
        "trans_err_mm": trans_err,
        "residual_mean_mm": res_mean,
        "residual_max_mm": res_max,
        "symmetric_icp": {"rot_err_mgon": sym_rot, "trans_err_mm": sym_trans},
        "nn_kernels": nn,
        "phases": result.timer.summary(),
        "fine_phases": fine,
        "launches": launches,
        "plain_on_cuda": plain_on_cuda,
        "trans_mat": result.trans_mat.tolist(),
        "n_points": int(len(pts1)),
        "seed": seed,
        "device": device_info(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the tests: the plain "
                    "versions, no device metric)")
    ap.add_argument("--n-side", type=int, default=N_SIDE,
                    help="points a side of each epoch (n_side^2 an epoch)")
    ap.add_argument("--res", type=float, default=RES,
                    help="voxel resolution (m); SV is 10 times it")
    ap.add_argument("--warm-reps", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3,
                    help="repeats of the campaigns and the ICP chain")
    args = ap.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False; the bench "
              "runs on the card (--device cpu only for the tests)",
              file=sys.stderr)
        return 2
    line = measure(args.seed, args.device, args.n_side, args.res,
                   args.warm_reps, args.reps)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
