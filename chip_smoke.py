#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``piecewise_icp_torch/csrc`` (nvcc),
holds each kernel against its plain PyTorch version at the main path's
shapes (a 142,884-point synthetic terrain epoch), then registers one
synthetic pair of such epochs end to end through
``piecewise_icp_torch.piecewise_icp_pair_call(..., device="cuda")`` and
checks the result against the known transform and that every kernel of
the path was launched.  Any failed check raises; the script exits 0 only
when every phase passed.  The last line of standard output is the JSON
summary ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the one before that the per-kernel JSON
record.

Needs a CUDA device: with none visible it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# main-path configuration: the reference's synthetic epoch (~142k points
# at 5 mm spacing) with the default PiecewiseICPConfig res/SV/DT
N_SIDE = 378
EXTENT = 2.0
PARAMS = [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005]
RES = 0.005
KNN_NORMALS = 45
SOR_K = 14
SV = 0.05

REPLACES = {
    "range_nn1": ("piecewise_icp_torch/csrc/range_nn1.cu",
                  "piecewise_icp_tpu/ops/nn_pallas.py:163"),
    "knn_sorted": ("piecewise_icp_torch/csrc/knn_sorted.cu",
                   "piecewise_icp_tpu/ops/nn_pallas.py:336"),
    "seg_stats": ("piecewise_icp_torch/csrc/seg_stats.cu",
                  "piecewise_icp_tpu/ops/seg_pallas.py:92"),
    "prop_round": ("piecewise_icp_torch/csrc/prop_round.cu",
                   "piecewise_icp_tpu/ops/seg_pallas.py:282"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event-timed calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def kernel_phases(seed: int) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from piecewise_icp_torch.models.segmentation_device import (
        _seg_h, propagate_seeds)
    from piecewise_icp_torch.ops import nn_cuda, seg_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
    from piecewise_icp_torch.models.piecewise_icp import _cell_order
    from piecewise_icp_torch.utils.synth import make_pair

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    c1, c2, _ = make_pair(rng, PARAMS, n_side=N_SIDE, extent=EXTENT)
    shift = -c1.astype(np.float64).mean(axis=0)
    p1 = (c1.astype(np.float64) + shift).astype(np.float32)
    p2 = (c2.astype(np.float64) + shift).astype(np.float32)
    n = p1.shape[0]
    log(f"kernel phases: terrain epoch of {n} points (n_side={N_SIDE}, "
        f"extent={EXTENT} m, seed={seed})")
    results = {}

    def fresh(g: CellGrid) -> CellGrid:
        # plain versions cache their brute neighbour lists on the grid;
        # a fresh copy makes each timed plain call pay for its own
        return dataclasses.replace(g, _self_nbr=[])

    # ---- self-join grid of segmentation / SOR (cell size h) ----
    h = _seg_h(KNN_NORMALS, RES)
    index = build_grid(p1, h)
    grid = CellGrid.from_index(index, dev)
    all_q = torch.ones(n, dtype=torch.bool, device=dev)

    # K2: SOR k-NN, k + 1 = 15
    k2 = SOR_K + 1
    ki, kd, kr = nn_cuda.knn_sorted(grid, all_q, k2)
    pi_, pd2 = nn_cuda.knn_sorted_plain(fresh(grid), all_q, k2)
    pd = torch.sqrt(torch.clamp(pd2, min=0.0))
    pr = torch.isfinite(pd[:, -1]) & (pd[:, -1] <= float(np.float32(h)))
    require(bool(kr.any()), "K2: no query resolved")
    require(bool((kr == pr).all()), "K2: resolved sets differ")
    require(bool((ki[kr] == pi_[kr]).all()), "K2: neighbour ids differ")
    err = max_abs(kd[kr], pd[kr])
    require(err == 0.0, f"K2: distances differ by {err}")
    results["knn_sorted"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda._knn_sorted_kernel(grid, all_q, k2)),
        plain_ms=time_ms(lambda: nn_cuda.knn_sorted_plain(
            fresh(grid), all_q, k2)))
    log(f"K2 knn_sorted k={k2} h={h:.6f}: {int(kr.sum())}/{n} resolved; "
        f"ids and distances of resolved queries equal (tolerance 0); "
        f"kernel {results['knn_sorted']['ms']:.3f} ms, plain (chunked "
        f"brute within h) {results['knn_sorted']['plain_ms']:.3f} ms")

    # K3: neighbourhood statistics, k = 45
    ks = seg_cuda._seg_stats_kernel(grid, all_q, KNN_NORMALS)
    ps = seg_cuda.seg_stats_plain(fresh(grid), all_q, KNN_NORMALS)
    require(bool((ks[:, 1] == ps[:, 1]).all()), "K3: t2 differs")
    require(bool((ks[:, 0] == ps[:, 0]).all()), "K3: counts differ")
    # sums are taken in another order: relative 1e-5 of each moment's
    # natural scale (count * h for first moments, count * h^2 for second)
    cnt = ps[:, 0:1]
    scale = torch.cat([cnt.expand(-1, 3) * h,
                       cnt.expand(-1, 6) * h * h], dim=1)
    dev_m = (ks[:, 2:11] - ps[:, 2:11]).abs()
    require(bool((dev_m <= 1e-5 * scale + 1e-12).all()),
            "K3: moment sums differ beyond 1e-5 relative")
    err = float((ks - ps).abs().max())
    t2k, nk = ks[:, 1], seg_cuda.normals_from_stats(ks)
    dots = (nk * seg_cuda.normals_from_stats(ps)).sum(dim=1).abs()
    require(bool((dots >= 1 - 1e-5).all()), "K3: normals differ")
    results["seg_stats"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: seg_cuda._seg_stats_kernel(grid, all_q,
                                                      KNN_NORMALS)),
        plain_ms=time_ms(lambda: seg_cuda.seg_stats_plain(
            fresh(grid), all_q, KNN_NORMALS)))
    log(f"K3 seg_stats k={KNN_NORMALS}: t2 and counts equal, moments within "
        f"1e-5 relative, normals |n.n'| >= 1-1e-5 (min {float(dots.min()):.8f}"
        f"); kernel {results['seg_stats']['ms']:.3f} ms, plain (brute "
        f"neighbours within h) {results['seg_stats']['plain_ms']:.3f} ms")

    # K4: one propagation round on a partly propagated state, both modes
    seeds = propagate_seeds(index.points[:n], SV)
    seed_idx = torch.from_numpy(seeds.astype(np.int64)).to(dev)
    qall = torch.cat([grid.points, nk, t2k[:, None],
                      torch.zeros_like(t2k)[:, None]], dim=1).contiguous()
    state = seg_cuda.init_state(grid.points, nk, seed_idx)
    inv = float(0.4 / SV)
    h2 = float(h) * float(h)
    for _ in range(3):
        state, _ = seg_cuda._prop_round_kernel(grid, qall, all_q, state,
                                               inv, h2, False)
    err = 0.0
    for adopt in (False, True):
        sk, ck = seg_cuda._prop_round_kernel(grid, qall, all_q, state, inv,
                                             h2, adopt)
        sp, cp = seg_cuda.prop_round_plain(fresh(grid), qall, all_q, state,
                                           inv, h2, adopt)
        require(bool((sk[:, 6] == sp[:, 6]).all()),
                f"K4 (adopt={adopt}): labels differ")
        require(int(ck) == int(cp), f"K4 (adopt={adopt}): change counts "
                f"{int(ck)} != {int(cp)}")
        err = max(err, float((sk - sp).abs().max()))
    require(err == 0.0, f"K4: state rows differ by {err}")
    results["prop_round"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: seg_cuda._prop_round_kernel(
            grid, qall, all_q, state, inv, h2, False)),
        plain_ms=time_ms(lambda: seg_cuda.prop_round_plain(
            fresh(grid), qall, all_q, state, inv, h2, False)))
    log(f"K4 prop_round: {len(seeds)} seeds, labels, state rows and change "
        f"counts equal in both modes (tolerance 0); kernel "
        f"{results['prop_round']['ms']:.3f} ms, plain (brute neighbours "
        f"within h) {results['prop_round']['plain_ms']:.3f} ms")

    # K1: stage-1 percentile 1-NN, moving source vs static target grid
    index1 = build_grid(p1, 4.0 * RES)
    grid1 = CellGrid.from_index(index1, dev)
    q = torch.from_numpy(p2[_cell_order(p2, index1)]).to(dev)
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    ki1, kd1, kr1, _ = nn_cuda.range_nn1(q, qm, grid1)
    pi1, pd21 = nn_cuda.range_nn1_plain(q, qm, grid1)
    pd1 = torch.sqrt(torch.clamp(pd21, min=0.0))
    pr1 = torch.isfinite(pd1) & (pd1 <= float(np.float32(grid1.h)))
    require(bool(kr1.any()), "K1: no query resolved")
    require(bool((kr1 == pr1).all()), "K1: resolved sets differ")
    require(bool((ki1[kr1] == pi1[kr1]).all()), "K1: nearest ids differ")
    err = max_abs(kd1[kr1], pd1[kr1])
    require(err == 0.0, f"K1: distances differ by {err}")
    results["range_nn1"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda._range_nn1_kernel(q, qm, grid1)),
        plain_ms=time_ms(lambda: nn_cuda.range_nn1_plain(q, qm, grid1)))
    log(f"K1 range_nn1 h={grid1.h}: {int(kr1.sum())}/{q.shape[0]} resolved; "
        f"ids and distances equal (tolerance 0); kernel "
        f"{results['range_nn1']['ms']:.3f} ms, plain (chunked brute) "
        f"{results['range_nn1']['plain_ms']:.3f} ms")
    return results


# ---------------------------------------------------------------------------
# pair phase
# ---------------------------------------------------------------------------


def pair_phase(seed: int) -> dict:
    """One registration through the user entry point, then warm repeats."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.transform import apply_transform_np
    from piecewise_icp_torch.utils.synth import make_pair
    from piecewise_icp_tpu.io import formats, read_pcd, write_pcd

    rng = np.random.default_rng(seed)
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=N_SIDE, extent=EXTENT)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_pcd(tmp / "Epoch_000.pcd", c1)
        write_pcd(tmp / "Epoch_001.pcd", c2)
        cfg = pwt.PiecewiseICPConfig(path1=str(tmp / "Epoch_000.pcd"),
                                     path2=str(tmp / "Epoch_001.pcd"))
        conf = tmp / "config_pair.txt"
        cfg.to_reference_file(conf)
        out_prefix = str(tmp / "out") + "/"
        pathlib.Path(out_prefix).mkdir()

        _cuda.reset_counts()
        t0 = time.perf_counter()
        ok = pwt.piecewise_icp_pair_call(str(conf), out_prefix,
                                         device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        plain_on_cuda = dict(_cuda.PLAIN_ON_CUDA)
        require(ok, "piecewise_icp_pair_call returned False")
        report = formats.read_trans_matrix_report(out_prefix
                                                  + "TransMatrix.txt")
        pts1 = read_pcd(cfg.path1)
        pts2 = read_pcd(cfg.path2)

    t_est = report["trans_mat"]
    vcm = report["vcm"]
    require(t_est.shape == (4, 4) and np.isfinite(t_est).all(),
            "TransMatrix.txt: transform not a finite 4x4")
    require(vcm.shape == (6, 6) and np.isfinite(vcm).all()
            and (np.diag(vcm) > 0).all(), "TransMatrix.txt: bad VCM")
    # the estimate maps cloud2 back onto cloud1: T_est @ T_true ~ identity
    m = t_est @ t_true
    disp = np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                          - c2.astype(np.float64), axis=1)
    log(f"pair: residual displacement vs truth mean {disp.mean() * 1e3:.4f}"
        f" mm, max {disp.max() * 1e3:.4f} mm (bounds 2 mm / 5 mm)")
    require(disp.mean() < 2e-3 and disp.max() < 5e-3,
            "pair result outside the truth bounds")
    for name in REPLACES:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the main path")
    require(not plain_on_cuda,
            f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    log(f"pair: launches {launches}; plain versions on CUDA: none")

    warm, res = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = register_pair(pts1, pts2, cfg, device="cuda")
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    profile_pair(lambda: register_pair(pts1, pts2, cfg, device="cuda"))
    core = res.core
    log(f"pair: cold {cold_s:.3f} s (entry point, PCD in / report out), "
        f"warm register_pair median of 3 {statistics.median(warm):.3f} s "
        f"({', '.join(f'{w:.3f}' for w in warm)}); patches "
        f"{core.num_patches}; outer iterations {core.iterations}; "
        f"inner ICP iterations {core.total_icp_iters}; guard fired "
        f"{res.guard_draws > 1} ({res.guard_draws} draws); source points "
        f"{len(pts2)}")
    return launches


def profile_pair(run) -> None:
    """One more warm registration under torch.profiler: host phases and
    device kernel time by name (where the time goes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from piecewise_icp_tpu.utils.logging import GLOBAL_TIMER

    GLOBAL_TIMER.records.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phases = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in
                       sorted(GLOBAL_TIMER.summary().items(),
                              key=lambda kv: -kv[1]))
    log(f"profile: profiled warm pair {wall * 1e3:.1f} ms; host phases "
        f"(ms, nested phases overlap): {phases}")
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: device busy {busy:.1f} ms of {wall * 1e3:.1f} ms wall "
        f"({100 * busy / max(wall * 1e3, 1e-9):.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    try:
        import piecewise_icp_torch  # noqa: F401
        from piecewise_icp_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 3

    smi = nvidia_smi_line()
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if pathlib.Path("/usr/local/cuda/bin/nvcc").exists() else None)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc {nvcc or 'not found'}")

    t0 = time.perf_counter()
    lib_path = _cuda.build()
    log(f"kernel library {lib_path.relative_to(_cuda.BUILD_ROOT.parent)} "
        f"ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    _cuda.lib()

    kern = kernel_phases(args.seed)
    launches = pair_phase(args.seed)
    require("jax" not in sys.modules, "JAX was imported")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches.get(name, 0)),
         "max_abs_err": kern[name]["max_abs_err"],
         "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]}
        for name, (src, rep) in REPLACES.items()]}
    print(json.dumps(record), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
