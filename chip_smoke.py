#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--only PHASE ...] [--sweep VARIANT ...]

Builds the port's CUDA kernels from ``piecewise_icp_torch/csrc`` (nvcc),
holds each kernel against its plain PyTorch version at the main path's
shapes (142,884-point synthetic terrain epochs; the grid 1-NN at the shape
of the stage-1 percentile and at that of adaptive planning; the brute 1-NN
also at the shape of the stage-1 rescue; the brute k-NN at the shapes of
resolution estimation, of the smoke pair's unified SOR rescue, of the SOR
of a cloud no grid fits and of the rockfall pair's SOR rescue; the three
self-join kernels also
on a grid with sentinel points and one cell crowded beyond the window a
block stages in shared memory, and the grid 1-NN on it too; the label propagation as one round and as the whole loop
in one launch, also with the round cap reached before convergence), works
out each kernel's bound on the card from these inputs, checks
resolution estimation against a float64 KD-tree, holds the voxel grouping
(K7) against the host ``voxel_downsample`` and ``propagate_seeds`` bit for
bit at the benchmark cells' shapes and times it (phase ``voxel``), then
drives the port's two entry points on the card:

1. one synthetic pair through
   ``piecewise_icp_torch.piecewise_icp_pair_call(...)`` with no ``device``
   argument (the default is the card), one 3,600-point pair that takes
   the staged preprocessing path, and one full-width pair with 6,000
   isolated points per epoch, which the unified path declines: the staged
   SOR re-measures every unresolved query on the card by the brute k-NN
   (and takes the brute k-NN on the card for every point when no grid
   fits);
2. reproducibility: a smoke epoch's PatchSet and a whole registration of
   the smoke pair, each twice, bit for bit;
3. the smoke pair under the symmetric objective and under inverse-variance
   weights; with one block of the source raised 2 mm and the change
   screen on; with ``isVisual: 1`` (the four colored PCDs), under
   ``PWICP_PROFILE_DIR`` (a trace) and ``PWICP_NO_UNIFIED=1`` (the staged
   path at full width); and through the C ABI
   (``PiecewiseICP_pair_call`` by ctypes); then the pairs and a 3-epoch
   campaign point-sharded over ranks (``parallel``: NCCL at 2 and 4 ranks,
   one card a rank, where four cards are visible; 2 gloo ranks sharing
   the one card otherwise), the multi-controller demo (2 host launchers
   meeting at ``tcp://127.0.0.1``) and, on four cards, the CLIs with
   ``--mesh-devices 4``;
4. a 20-epoch 4D campaign of 142,884-point epochs drifting 2 cm a step
   through ``piecewise_icp_torch.piecewise_icp_4d_call(...,
   device="cuda")`` in adaptive mode (the plan advances its target) with
   auto DT-init and Kalman smoothing, then its first 5 epochs twice (once
   profiled), whose tables must be byte-equal;
5. the rockfall configurations (BASELINE 3 and 4) at the reference's scale
   on the series of ``piecewise_icp_torch.utils.rockfall``: the pair of
   epochs 1 and 2 (the staged path; its transform within 0.5 mm at the box
   corners of the JAX package's, a constant here), the same pair with the
   acceptance guard firing, and the 6-epoch Kalman campaign through
   ``piecewise_icp_4d_call``; then K1-K6 against their plain versions at
   that path's shapes;
6. BASELINE configuration 5 on the series of
   ``piecewise_icp_torch.utils.scale``: 101 epochs of the 142,884-point
   base as epoch fleets of 1, 2 and 4 concurrent worker processes sharing
   the card (``run_fleet``; the tables of every fleet the same bytes, each
   worker's launches read from its report), with the card's utilization
   and memory sampled while they run; then the quasi-static Kalman
   campaign of the same base;
7. ``bench_torch.py``'s measurement in this process (the bench pair's
   cold, warm and fresh-process times, the serial and ``run_4d``
   campaigns, K1, K2 and K5 against their bounds and ``torch.cdist``, the
   inner-ICP rate), its line printed as it is,

each checked against the known transforms, with the launch counts of the
kernels read around each path.  Any failed check raises, as does a loaded
JAX or JAX package; the script exits 0 only when every phase passed.  The
last line of standard output is the JSON summary ``{"ok": true, "device":
{...}}``; the line before it is the card's name and power limit, and the
one before that the per-kernel JSON record (launches counted in the 4D
campaign, which runs the five TPU kernels' counterparts and the voxel
grouping, and for the brute k-NN in the rockfall phase; times, bounds and
errors of this run; the whole-loop launch of the label propagation and each
of the voxel grouping's two entries have a row of their own).

``python3 chip_smoke.py --only PHASE [PHASE ...]`` builds the kernels and
runs only the named phases of 2, 3, 5, 6 and 7 (or the pair of 1, or
``voxel``), with no JSON record: the way to run one phase on another tree, such as a parent's.

``python3 chip_smoke.py --sweep VARIANT [VARIANT ...]`` runs none of the
above: it times K1-K4 and K4's whole loop at the same shapes (K1 at both of
its shapes, the stage-1 percentile's and adaptive planning's, as the
kernel's wrapper, as the public call and under the stage-1 percentile that
calls it, each with the launches a call puts on the device) and K6 at its
five path shapes, for the sources as they are
(``base``) or with compile-time constants replaced (for example
``kPropCap=256,kSegWarps=8``, ``kRangeLanes=16`` or ``kKnnQpw=2``;
``kRangeWalk=0`` is the floor of K1's launch: bounds read, outputs
written, no candidate met; ``kKnnTally=1`` prints K6's counts), and prints
one JSON line a variant.  This is how the staged caps, the warps a block,
K1's lanes a query and K6's layout were chosen.

Needs a CUDA device: with none visible it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import importlib
import json
import logging
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from piecewise_icp_torch.utils.measure import (bound, grid_bytes,
                                               knn_brute_bound,
                                               knn_sorted_bound,
                                               nn1_brute_bound,
                                               nvidia_smi_line,
                                               range_nn1_bound, time_ms,
                                               truth_mm, window_counts,
                                               window_pairs)

# main-path configuration: the reference's synthetic epoch (~142k points
# at 5 mm spacing) with the default PiecewiseICPConfig res/SV/DT
N_SIDE = 378
EXTENT = 2.0
PARAMS = [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005]
RES = 0.005
KNN_NORMALS = 45
SOR_K = 14
SV = 0.05
DT_INIT = 0.05

REPLACES = {
    "range_nn1": ("piecewise_icp_torch/csrc/range_nn1.cu",
                  "piecewise_icp_tpu/ops/nn_pallas.py:163"),
    "knn_sorted": ("piecewise_icp_torch/csrc/knn_sorted.cu",
                   "piecewise_icp_tpu/ops/nn_pallas.py:336"),
    "seg_stats": ("piecewise_icp_torch/csrc/seg_stats.cu",
                  "piecewise_icp_tpu/ops/seg_pallas.py:92"),
    "prop_round": ("piecewise_icp_torch/csrc/prop_round.cu",
                   "piecewise_icp_tpu/ops/seg_pallas.py:282"),
    "nn1_brute": ("piecewise_icp_torch/csrc/nn1_brute.cu",
                  "piecewise_icp_tpu/ops/nn_pallas.py:59"),
    # the whole loop of K4's rounds in one launch (the reference runs its
    # two while_loops inside one jitted program)
    "propagate": ("piecewise_icp_torch/csrc/prop_round.cu",
                  "piecewise_icp_tpu/ops/seg_pallas.py:490"),
    # hand-written, no Pallas counterpart: the exact k-NN statistic to which
    # the JAX package's TPU branch hands a declined cloud (the rockfall
    # pair's staged SOR), also its in-program rescue and ops/nn.py:knn
    "knn_brute": ("piecewise_icp_torch/csrc/knn_brute.cu",
                  "piecewise_icp_tpu/native/pwicp_host.cpp:351"),
    # hand-written, no Pallas counterpart: the voxel grouping, for the two
    # host numpy functions of the JAX package, the voxel-grid downsample
    # and the supervoxel seed choice; both entries run in both
    "voxel_keys": ("piecewise_icp_torch/csrc/voxel.cu",
                   "piecewise_icp_tpu/ops/preprocess.py:28"),
    "voxel_segments": ("piecewise_icp_torch/csrc/voxel.cu",
                       "piecewise_icp_tpu/models/segmentation_device.py:108"),
}

# the kernels of the pair path with the default configuration (DTinit
# set, so no K5)
PAIR_KERNELS = ("range_nn1", "knn_sorted", "seg_stats", "prop_round",
                "propagate", "voxel_keys", "voxel_segments")
# the kernels the drifting campaign must launch (auto DT-init: K5 too);
# K6 runs there only where the unified SOR leaves queries to its rescue
CAMPAIGN_KERNELS = PAIR_KERNELS + ("nn1_brute",)
# the kernels of the rockfall path (both clouds decline the unified path:
# the staged SOR re-measures its unresolved queries by K6)
ROCKFALL_KERNELS = PAIR_KERNELS + ("knn_brute",)
# the voxel grouping's synthetic epoch: that of the benchmark's pair cells
VOXEL_N_SIDE = 418

# the 4D campaign: the reference's synthetic series length, random-walk
# ground truth per step (rotation std 8e-4 rad, translation std 3 mm) plus
# a 2 cm vertical trend, which carries an epoch beyond DTinit (5 cm) of the
# target two or three epochs back, so the adaptive plan advances
N_EPOCHS = 20
TREND_4D = (0.0, 0.0, 0.02)
# the timer phases that each hold one call of the K5 wrapper: the stage-1
# rescue, and the others (auto DT-init once a pair, an overlap ratio of
# adaptive planning where no grid fits, the exact percentile where the
# rescue budget did not cover every unresolved query)
K5_RESCUE_PHASE = "core.stage1_rescue"
K5_OTHER_PHASES = ("core.dtinit", "plan.overlap_brute",
                   "core.percentile_exact")

# queries of the stage-1 rescue (the budget of the core loop)
N_RESCUE = 49152

# the staged SOR at full width: isolated points scattered above both epochs,
# more than the rescue budget of the unified path (4,096), which declines
N_SPARSE = 6000

# BASELINE configurations 3 and 4: the rockfall series of
# piecewise_icp_torch/utils/rockfall.py at the reference's scale (the
# defaults of eval/rockfall_sim.py), registered with the reference's rockfall
# configuration (res 0.3 m, SV 3 m, DTinit 0.1 m, DTmin 0.03 m)
ROCKFALL_EPOCHS = 6
ROCKFALL_EXTENT = (150.0, 100.0)
ROCKFALL_RES = 0.3
ROCKFALL_SEED = 7
# the second pair's guard threshold, above the pair's stable ratio: the
# acceptance guard fires
ROCKFALL_GUARD_RATIO = 0.9
# the JAX package's transform of that pair (configuration 3, epochs 1 and
# 2), from its own register_pair with its TPU branch forced on the CPU;
# printed, and held against these numbers, by
#     python -m pytest tests/test_torch_rockfall.py -m slow -k full_scale -s
JAX_ROCKFALL_PAIR = np.array([
    [1.000000003718868, 8.994180545334548e-06,
     -8.718929412113982e-05, 0.004937960722915191],
    [-9.001476630847545e-06, 1.0000000043615298,
     -8.367824148930049e-05, -0.0014367141997695398],
    [8.718853958043741e-05, 8.367902684357334e-05,
     1.0000000078575995, -0.004299780845478551],
    [0.0, 0.0, 0.0, 1.0]])

# BASELINE configuration 5: the scaled 4D campaign of
# piecewise_icp_torch/utils/scale.py (eval/scale_demo.py's series: the
# 142,884-point base moved by a random walk of 5e-4 rad and 4 mm a step,
# fresh 1.5 mm noise each epoch, 4-digit names; its configuration res 0.005,
# SV 0.05, DTinit 0.05, DTmin 0.004, Kalman), fixed interval 1, as epoch
# fleets of W concurrent worker processes sharing the card
FLEET_EPOCHS = 101
FLEET_WORKERS = (1, 2, 4)
# the kernels every worker of the fleet must launch (DTinit set: no K5)
FLEET_KERNELS = ("range_nn1", "knn_sorted", "seg_stats", "propagate",
                 "voxel_keys", "voxel_segments")
# the quasi-static Kalman campaign (eval/kalman_quasistatic.py) and the
# independent-component reduction the JAX package reports for it on the
# reference scan, another base (eval/kalman_quasistatic.json)
QUASI_EPOCHS = 12
JAX_QUASI_REDUCTION = 3.46

# the tables two runs of one campaign must write byte for byte
REPRO_TABLES = ("TransMatrices_toRef.txt", "TransPara_AbsError.txt")

OUTPUTS_4D = ("TransMatrices.txt", "TransParameters.txt",
              "TransMatrices_toRef.txt", "TransParameters_toRef.txt",
              "TransPara_AbsError.txt", "TransMatrices_toRef_smoothed.txt",
              "TransParameters_toRef_smoothed.txt",
              "TransPara_AbsError_smoothed.txt", "RegPairFile.txt",
              "phase_timings.jsonl")


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def smoke_pair(seed: int):
    """The smoke pair as a user hands it over: (cloud1, cloud2, T_true)."""
    from piecewise_icp_torch.utils.synth import make_pair

    return make_pair(np.random.default_rng(seed), PARAMS, n_side=N_SIDE,
                     extent=EXTENT)


def bit_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Elements of two arrays whose bits differ (-1: other shape or type)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    u = np.dtype(f"u{a.dtype.itemsize}")
    return int(np.count_nonzero(np.ascontiguousarray(a).view(u)
                                != np.ascontiguousarray(b).view(u)))


def smoke_epochs(seed: int):
    """The two 142,884-point epochs of the smoke pair, centred on the first
    (float32)."""
    c1, c2, _ = smoke_pair(seed)
    shift = -c1.astype(np.float64).mean(axis=0)
    return ((c1.astype(np.float64) + shift).astype(np.float32),
            (c2.astype(np.float64) + shift).astype(np.float32))


def propagation_inputs(grid, q_mask, normals, t2, rounds: int,
                       sv: float = SV):
    """K4's operands on ``grid`` as segmentation makes them: the seeds of
    the live points, the query rows, the metric's constants, and the seed
    state carried through ``rounds`` propagation rounds of the kernel.
    Returns (seed_idx, qall, inv_res_04, h2, state)."""
    import torch

    from piecewise_icp_torch.models.segmentation_device import propagate_seeds
    from piecewise_icp_torch.ops import seg_cuda

    live = np.flatnonzero(q_mask.cpu().numpy())
    seeds = live[propagate_seeds(grid.points.cpu().numpy()[live], sv)]
    seed_idx = torch.from_numpy(seeds.astype(np.int64)).to(grid.points.device)
    qall = torch.cat([grid.points, normals, t2[:, None],
                      torch.zeros_like(t2)[:, None]], dim=1).contiguous()
    inv, h2 = float(0.4 / sv), float(grid.h) * float(grid.h)
    state = seg_cuda.init_state(grid.points, normals, seed_idx)
    for _ in range(rounds):
        state, _ = seg_cuda._prop_round_kernel(grid, qall, q_mask, state, inv,
                                               h2, False)
    return seed_idx, qall, inv, h2, state


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def fresh_grid(grid):
    """A copy of ``grid`` without the plain versions' cached brute
    neighbour lists, so that each timed plain call pays for its own."""
    return dataclasses.replace(grid, _self_nbr=[])


def self_join_facts(grid, where: str):
    """(candidates of the self-join's windows, the grid's bytes), logged
    with the grid's cells and widest window."""
    n, n_cells = grid.n, grid.n_cells
    cells = grid.cell_starts[:n_cells + 1].long()
    widest = int(window_counts(grid).max())
    log(f"{where}: {n} points, {grid.dims} = {n_cells} cells of "
        f"{grid.h:.6f} m, {int((cells[1:] > cells[:-1]).sum())} occupied; "
        f"the widest 27-cell window holds {widest} points")
    return window_pairs(grid), grid_bytes(grid), widest


def knn_check(grid, where: str) -> dict:
    """K2 (the SOR k-NN, k + 1 = 15) against its plain version on the
    self-join of ``grid``: resolved flags, ids and distances of resolved
    queries at tolerance 0; then both times and the bound."""
    import torch

    from piecewise_icp_torch.ops import nn_cuda

    n, h, k2 = grid.n, grid.h, SOR_K + 1
    all_q = torch.ones(n, dtype=torch.bool, device=grid.points.device)
    ki, kd, kr = nn_cuda.knn_sorted(grid, all_q, k2)
    pi_, pd2 = nn_cuda.knn_sorted_plain(fresh_grid(grid), all_q, k2)
    pd = torch.sqrt(torch.clamp(pd2, min=0.0))
    pr = torch.isfinite(pd[:, -1]) & (pd[:, -1] <= float(np.float32(h)))
    require(bool(kr.any()), f"K2 ({where}): no query resolved")
    require(bool((kr == pr).all()), f"K2 ({where}): resolved sets differ")
    require(bool((ki[kr] == pi_[kr]).all()),
            f"K2 ({where}): neighbour ids differ")
    err = max_abs(kd[kr], pd[kr])
    require(err == 0.0, f"K2 ({where}): distances differ by {err}")
    # the self-join's candidates: every grid kernel meets them all
    pairs, _, widest = self_join_facts(grid, where)
    res = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda._knn_sorted_kernel(grid, all_q, k2)),
        plain_ms=time_ms(lambda: nn_cuda.knn_sorted_plain(
            fresh_grid(grid), all_q, k2)),
        **knn_sorted_bound(grid, k2, pairs))
    cap = _kernel_cap("pwicp_knn_cap")
    log(f"K2 knn_sorted ({where}) k={k2} h={h:.6f}: {int(kr.sum())}/{n} "
        f"resolved; ids and distances of resolved queries equal (tolerance "
        f"0); {pairs} candidates in the windows ({pairs / n:.1f} a query); "
        f"widest window {widest}, staged cap {cap}: walked branch "
        f"{'ran' if widest > cap else 'not run'}; kernel {res['ms']:.3f} "
        f"ms, plain (chunked brute within h) {res['plain_ms']:.3f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def _kernel_cap(name: str) -> int:
    """A staged window's cap as the kernel library reports it."""
    from piecewise_icp_torch.ops import _cuda

    return int(getattr(_cuda.lib(), name)())


def seg_prop_checks(grid, sv: float, where: str,
                    determined_only: bool = False) -> dict:
    """K3 (neighbourhood statistics, k = 45), one K4 round in both modes
    and K4's whole loop against their plain versions on the self-join of
    ``grid`` with supervoxel size ``sv``; times and bounds.
    ``determined_only``: K3's normals are held where its moment tolerance
    determines them (``stats_check``)."""
    import torch

    from piecewise_icp_torch.ops import seg_cuda

    n, h = grid.n, grid.h
    all_q = torch.ones(n, dtype=torch.bool, device=grid.points.device)
    pairs, g_bytes, widest = self_join_facts(grid, where)
    results = {}
    ks = seg_cuda._seg_stats_kernel(grid, all_q, KNN_NORMALS)
    ps = seg_cuda.seg_stats_plain(fresh_grid(grid), all_q, KNN_NORMALS)
    err, min_dot = stats_check(ks, ps, h, all_q, f"K3 ({where})",
                               determined_only)
    require(bool((seg_cuda._seg_stats_kernel(grid, all_q, KNN_NORMALS)
                  == ks).all()), f"K3 ({where}): two runs gave different "
            "bits")
    t2k, nk = ks[:, 1], seg_cuda.normals_from_stats(ks)
    results["seg_stats"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: seg_cuda._seg_stats_kernel(grid, all_q,
                                                      KNN_NORMALS)),
        plain_ms=time_ms(lambda: seg_cuda.seg_stats_plain(
            fresh_grid(grid), all_q, KNN_NORMALS)),
        # a distance (8), one comparison of the selection of the k-th
        # radius and the test against t2 for each candidate; 10 sums and 6
        # products for each neighbour kept (the counts of the output)
        **bound(g_bytes + n + 64 * n,
                10 * pairs + 16 * float(ks[:, 0].sum())))
    seg_cap, prop_cap = (_kernel_cap("pwicp_seg_cap"),
                         _kernel_cap("pwicp_prop_cap"))
    log(f"K3 seg_stats ({where}) k={KNN_NORMALS}: t2 and counts equal, "
        f"moments within 1e-5 relative (largest difference {err:.3g}), "
        f"normals |n.n'| >= 1-1e-5 (min {min_dot:.8f}), the same bits in "
        f"two runs; widest window {widest}, staged cap {seg_cap}: walked "
        f"branch {'ran' if widest > seg_cap else 'not run'}; kernel "
        f"{results['seg_stats']['ms']:.3f} ms, plain (brute neighbours "
        f"within h) {results['seg_stats']['plain_ms']:.3f} ms, bound "
        f"{results['seg_stats']['bound_ms']:.4f} ms")

    # K4: one propagation round on a partly propagated state, both modes
    seed_idx, qall, inv, h2, state = propagation_inputs(grid, all_q, nk, t2k,
                                                        3, sv)
    err = 0.0
    for adopt in (False, True):
        sk, ck = seg_cuda._prop_round_kernel(grid, qall, all_q, state, inv,
                                             h2, adopt)
        sp, cp = seg_cuda.prop_round_plain(fresh_grid(grid), qall, all_q,
                                           state, inv, h2, adopt)
        require(bool((sk[:, 6] == sp[:, 6]).all()),
                f"K4 ({where}, adopt={adopt}): labels differ")
        require(int(ck) == int(cp), f"K4 ({where}, adopt={adopt}): change "
                f"counts {int(ck)} != {int(cp)}")
        err = max(err, float((sk - sp).abs().max()))
    require(err == 0.0, f"K4 ({where}): state rows differ by {err}")
    round_bytes = g_bytes + 32 * n + n + 32 * n + 32 * n + 4
    results["prop_round"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: seg_cuda._prop_round_kernel(
            grid, qall, all_q, state, inv, h2, False)),
        plain_ms=time_ms(lambda: seg_cuda.prop_round_plain(
            fresh_grid(grid), qall, all_q, state, inv, h2, False)),
        # the label test, a distance and its comparison for each
        # candidate (the metric of the candidates kept is not counted)
        **bound(round_bytes, 10 * pairs))
    log(f"K4 prop_round ({where}): {len(seed_idx)} seeds (SV {sv} m), "
        f"labels, state rows and change counts equal in both modes "
        f"(tolerance 0); widest window {widest}, staged cap {prop_cap}: "
        f"walked branch {'ran' if widest > prop_cap else 'not run'}; kernel "
        f"{results['prop_round']['ms']:.3f} ms, plain (brute neighbours "
        f"within h) {results['prop_round']['plain_ms']:.3f} ms, bound "
        f"{results['prop_round']['bound_ms']:.4f} ms")
    results["propagate"] = propagate_check(
        grid, fresh_grid, nk, t2k, all_q, seed_idx, qall, inv, h2,
        results["prop_round"], round_bytes, 10 * pairs, sv)
    return results


def kernel_phases(seed: int) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from piecewise_icp_torch.models.segmentation_device import _seg_h
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
    from piecewise_icp_torch.models.piecewise_icp import _cell_order

    dev = torch.device("cuda")
    p1, p2 = smoke_epochs(seed)
    n = p1.shape[0]
    log(f"kernel phases: terrain epoch of {n} points (n_side={N_SIDE}, "
        f"extent={EXTENT} m, seed={seed})")

    # ---- self-join grid of segmentation / SOR (cell size h) ----
    h = _seg_h(KNN_NORMALS, RES)
    grid = CellGrid.from_index(build_grid(p1, h), dev)
    results = {"knn_sorted": knn_check(grid, "self-join grid")}
    results.update(seg_prop_checks(grid, SV, "self-join grid"))
    crowded_check(p1, h, SOR_K + 1, seed)

    # K1 at the two shapes the main path gives it: the stage-1 percentile
    # (moving source, cell-sorted, against the static target grid of
    # 4 * res) and adaptive planning (a whole epoch in file order, no mask,
    # against a target grid of DTinit)
    index1 = build_grid(p1, 4.0 * RES)
    q = torch.from_numpy(p2[_cell_order(p2, index1)]).to(dev)
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    results["range_nn1"] = range_nn1_check(
        "stage 1", CellGrid.from_index(index1, dev), q, qm, reps=5)
    plan = range_nn1_check(
        "planning", CellGrid.from_index(build_grid(p1, DT_INIT), dev),
        torch.from_numpy(p2).to(dev), None, reps=1)
    results["range_nn1"].update({f"{k}_plan": v for k, v in plan.items()
                                 if k != "library_ms"})
    return results


def range_nn1_equal(shape: str, grid, q, qm):
    """K1 against its plain version on these operands, tolerance 0: the
    resolved flags and the count of unresolved queries everywhere, ids and
    distances of the resolved queries (an unresolved query's window does
    not hold its true nearest); the count is reset by every launch.
    Returns (largest distance difference, resolved flags, count)."""
    import torch

    from piecewise_icp_torch.ops import nn_cuda

    ki, kd, kr, kn = nn_cuda._range_nn1_kernel(q, qm, grid)
    pi, pd, pr, pn = nn_cuda.range_nn1_plain(q, qm, grid)
    require(bool(kr.any()), f"K1 ({shape}): no query resolved")
    require(bool((kr == pr).all()), f"K1 ({shape}): resolved sets differ")
    require(bool((ki[kr] == pi[kr]).all()),
            f"K1 ({shape}): nearest ids differ")
    # a masked query is resolved at (0, inf) on both sides
    require(bool((kd[kr] == pd[kr]).all()),
            f"K1 ({shape}): distances differ")
    met = kr & torch.isfinite(pd)
    err = max_abs(kd[met], pd[met])
    require(err == 0.0, f"K1 ({shape}): distances differ by {err}")
    require(int(kn) == int(pn) == int((~kr).sum()),
            f"K1 ({shape}): {int(kn)} unresolved counted, plain {int(pn)}, "
            f"flags {int((~kr).sum())}")
    again = nn_cuda.range_nn1_counted(q, qm, grid)
    require(int(again[4]) == int(kn) and bool((again[1] == kd).all()),
            f"K1 ({shape}): a second launch gave another count or distance")
    return err, kr, kn


def range_nn1_check(shape: str, grid, q, qm, reps: int) -> dict:
    """K1 held against its plain version at one of the main path's shapes,
    then the times of both and the bound."""
    from piecewise_icp_torch.ops import nn_cuda

    nq = q.shape[0]
    err, kr, kn = range_nn1_equal(shape, grid, q, qm)
    pairs = window_pairs(grid, q, qm)
    res = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda._range_nn1_kernel(q, qm, grid)),
        plain_ms=time_ms(lambda: nn_cuda.range_nn1_plain(q, qm, grid),
                         reps=reps),
        **range_nn1_bound(grid, nq, qm is not None, pairs))
    log(f"K1 range_nn1, {shape}: h={grid.h}, {nq} queries "
        f"({'no mask' if qm is None else 'all live'}), {int(kr.sum())} "
        f"resolved, {int(kn)} counted unresolved; flags, count, ids and "
        f"distances equal (tolerance 0), the count the same in a second "
        f"launch; {pairs} candidates in the windows ({pairs / nq:.1f} a "
        f"query); kernel {res['ms']:.3f} ms, plain (chunked brute) "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


# the normals of two sets of K3 moments that meet the 1e-5 moment tolerance
# (every covariance entry within 3e-5 h^2, so the error's spectral norm
# within 9e-5 h^2) agree to |n . n'| >= 1 - 1e-5 (an angle of 4.47e-3)
# wherever the two smallest eigenvalues lie this far apart, in units of
# h^2 (Davis-Kahan: sin angle <= 2 |error| / gap)
NORMAL_GAP = 2 * 9e-5 / 4.47e-3


def stats_check(ks, ps, h: float, q_mask, what: str,
                determined_only: bool = False):
    """K3's rows against the plain version's: t2 and counts equal; the
    moment sums, taken in another order, within 1e-5 of each moment's
    natural scale (count * h for first moments, count * h^2 for second);
    normals |n . n'| >= 1 - 1e-5, everywhere, or with ``determined_only``
    where the moment tolerance determines the normal to that (an eigengap
    of NORMAL_GAP * h^2; the other queries' normals are reported).
    Returns (largest difference, least |n . n'| over the live queries, or
    over those determined)."""
    import torch

    from piecewise_icp_torch.ops import seg_cuda
    from piecewise_icp_torch.ops.eigh3 import eigvals3

    require(bool((ks[:, 1] == ps[:, 1]).all()), f"{what}: t2 differs")
    require(bool((ks[:, 0] == ps[:, 0]).all()), f"{what}: counts differ")
    cnt = ps[:, 0:1]
    scale = torch.cat([cnt.expand(-1, 3) * h,
                       cnt.expand(-1, 6) * h * h], dim=1)
    dev_m = (ks[:, 2:11] - ps[:, 2:11]).abs()
    require(bool((dev_m <= 1e-5 * scale + 1e-12).all()),
            f"{what}: moment sums differ beyond 1e-5 relative")
    require(bool((ks[:, 11:] == 0).all()), f"{what}: the row's tail is not 0")
    dots = (seg_cuda.normals_from_stats(ks)
            * seg_cuda.normals_from_stats(ps)).sum(dim=1).abs()[q_mask]
    if determined_only:
        vals = eigvals3(seg_cuda.covariance_from_stats(ps))[q_mask]
        firm = (vals[:, 1] - vals[:, 2]) >= NORMAL_GAP * h * h
        loose = dots[~firm]
        log(f"{what}: the moments determine {int(firm.sum())} of "
            f"{len(dots)} normals to 1 - 1e-5 (eigengap >= "
            f"{NORMAL_GAP * h * h:.4g} m^2); of the other {len(loose)}, "
            f"{int((loose < 1 - 1e-5).sum())} differ beyond it (least "
            f"|n.n'| {float(loose.min()) if len(loose) else 1.0:.8f})")
        dots = dots[firm]
    require(bool((dots >= 1 - 1e-5).all()), f"{what}: normals differ")
    return float((ks - ps).abs().max()), float(dots.min())


def propagate_check(grid, fresh, normals, t2, q_mask, seed_idx, qall, inv,
                    h2, one_round: dict, round_bytes: float,
                    round_ops: float, sv: float = SV) -> dict:
    """K4's whole loop in one launch against the host loop over the plain
    round (labels and round count, tolerance 0), also with the round cap
    reached before convergence; its time beside the host loop over the
    one-round kernel, which reads the change count back every round."""
    import torch

    from piecewise_icp_torch.ops import _cuda, seg_cuda

    def host_loop(max_rounds: int = 256):
        state = seg_cuda.init_state(grid.points, normals, seed_idx)
        rounds, sweep_starts = 0, []
        for adopt in (False, True):
            it, changed = 0, 1
            while changed > 0 and it < max_rounds:
                if adopt:
                    sweep_starts.append(state)
                state, chg = seg_cuda._prop_round_kernel(
                    grid, qall, q_mask, state, inv, h2, adopt)
                changed = int(chg)
                it += 1
            if not adopt:
                rounds = it
        return state, rounds, sweep_starts

    def whole(max_rounds: int = 256):
        return seg_cuda._propagate_kernel(grid, normals, t2, q_mask, seed_idx,
                                          sv, max_rounds)

    def plain(max_rounds: int = 256):
        return seg_cuda.propagate_rounds_plain(
            fresh(grid), normals, t2, q_mask, seed_idx, sv, max_rounds)

    n0 = dict(_cuda.LAUNCHES)
    kl, kr = whole()
    require(_cuda.LAUNCHES["propagate"] == n0.get("propagate", 0) + 1
            and _cuda.LAUNCHES["prop_round"] == n0.get("prop_round", 0) + 1,
            "K4 whole loop: not one launch")
    pl, pr = plain()
    final, hr, sweep_starts = host_loop()
    steps = hr + len(sweep_starts)
    hl = seg_cuda._labels_of(final, q_mask)
    require(kr == pr == hr, f"K4 whole loop: {kr} rounds, plain {pr}, host "
            f"loop over the round kernel {hr}")
    require(bool((kl == pl).all()), "K4 whole loop: labels differ from the "
            "plain loop's")
    require(bool((kl == hl).all()), "K4 whole loop: labels differ from the "
            "host loop's over the round kernel")
    require(2 < kr < 256, f"K4 whole loop: {kr} rounds")
    labelled = float((kl >= 0).float().mean())
    require(labelled > 0.99, f"K4 whole loop: {labelled:.4f} labelled")
    kl2, kr2 = whole(2)
    pl2, pr2 = plain(2)
    require(kr2 == pr2 == 2 and bool((kl2 == pl2).all()),
            "K4 whole loop, max_rounds=2: differs from the plain loop")
    require(bool((kl2 != kl).any()),
            "K4 whole loop, max_rounds=2: the cap changed nothing")
    # a propagation round meets every candidate of every live query; a
    # sweep round only those of the queries that enter it unlabelled (no
    # other row can change), at the same 10 instructions a candidate: the
    # loop needs the work of kr rounds and of that share of a round
    sweep_pairs = sum(window_pairs(grid, q_mask=q_mask & ~(s[:, 6] >= 0))
                      for s in sweep_starts)
    work = kr + 10 * sweep_pairs / round_ops
    res = dict(max_abs_err=float((kl - pl).abs().max()),
               ms=time_ms(whole), plain_ms=time_ms(plain, reps=1),
               **bound(work * round_bytes, work * round_ops))
    host_ms = time_ms(host_loop)
    # a sweep round on the converged state: every query is labelled and
    # skips its walk, so what is left is the hand-out of the cells, their
    # run tables and the staging of every window
    floor_ms = time_ms(lambda: seg_cuda._prop_round_kernel(
        grid, qall, q_mask, final, inv, h2, True))
    log(f"K4 propagate, the whole loop in one launch: {kr} rounds and "
        f"{steps - kr} of the orphan sweep ({sweep_pairs} candidates of the "
        f"queries it found unlabelled: the work of {work:.4f} rounds), "
        f"{100 * labelled:.2f}% labelled; "
        f"labels and round count equal to the plain loop and to the host "
        f"loop over the round kernel (tolerance 0), also with max_rounds=2; "
        f"{res['ms']:.3f} ms with one host read, against {host_ms:.3f} ms "
        f"for the host loop over the round kernel ({steps} launches, a read "
        f"a round) and {steps} x {one_round['ms']:.3f} = "
        f"{steps * one_round['ms']:.3f} ms of round kernels; plain loop "
        f"{res['plain_ms']:.3f} ms; a sweep round on the converged state "
        f"(cells handed out, run tables, every window staged, no query "
        f"walked: the floor of a block-a-cell kernel on this grid, its "
        f"wrapper included) {floor_ms:.3f} ms")
    return res


def crowded_check(p1: np.ndarray, h: float, k: int, seed: int) -> None:
    """The self-join kernels (K2, K3, K4) on a grid that holds sentinel
    points and one cell crowded beyond the window a block can stage in
    shared memory: each kernel's walk from global memory runs on the card,
    and both branches equal the plain version (K3's moments within their
    tolerance).  The window of a query is its cell's here: the sentinel
    points keep their cells and are masked queries."""
    import torch

    from piecewise_icp_torch.ops import _cuda, nn_cuda, seg_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 4)
    lib = _cuda.lib()
    cap = max(lib.pwicp_knn_cap(), lib.pwicp_seg_cap(), lib.pwicp_prop_cap())
    centre = p1[len(p1) // 2]
    crowd = centre + rng.uniform(-0.2 * h, 0.2 * h,
                                 (cap + 200, 3)).astype(np.float32)
    pts = np.concatenate([p1, crowd])
    n = len(pts)
    grid = CellGrid.from_index(build_grid(pts, h), dev)
    # SOR-removed points sit at the sentinel in place (some of the crowd too)
    gone = torch.from_numpy(rng.uniform(size=n) < 0.004).to(dev)
    grid = grid.with_points(torch.where(
        gone[:, None], torch.tensor(1e30, device=dev), grid.points))
    qm = ~gone
    widest = int(window_counts(grid).max())
    require(widest > cap, f"crowded: the widest window holds {widest} "
            f"points, not more than the staged {cap}")

    def fresh():
        return dataclasses.replace(grid, _self_nbr=[])

    ki, kd, kr = nn_cuda.knn_sorted(grid, qm, k)
    pi_, pd2 = nn_cuda.knn_sorted_plain(fresh(), qm, k)
    torch.cuda.synchronize()
    pd = torch.sqrt(torch.clamp(pd2, min=0.0))
    pr = ~qm | (torch.isfinite(pd[:, -1])
                & (pd[:, -1] <= float(np.float32(h))))
    require(bool((kr == pr).all()), "K2 crowded: resolved sets differ")
    require(bool((ki[kr] == pi_[kr]).all()), "K2 crowded: ids differ")
    require(bool((kd[kr] == pd[kr]).all()), "K2 crowded: distances differ")
    require(bool((ki[gone] == -1).all()) and bool(torch.isinf(kd[gone]).all()),
            "K2 crowded: a masked query was answered")
    got = ki[qm]
    require(not bool((gone[got.clamp(min=0)] & (got >= 0)).any()),
            "K2 crowded: a sentinel point was matched")
    log(f"K2 knn_sorted, crowded: {n} points, {int(gone.sum())} at the "
        f"sentinel (masked queries), widest window {widest} > {cap} staged: "
        f"{int(kr.sum())}/{n} resolved, ids and distances equal "
        f"(tolerance 0) on both branches")

    # K1 has one path for every window size: the grid's points, moved a
    # little, ask as its queries (those at the sentinel masked)
    q = torch.where(gone[:, None], grid.points, grid.points + torch.from_numpy(
        rng.normal(scale=0.3 * h, size=(n, 3)).astype(np.float32)).to(dev))
    _, kr1, kn1 = range_nn1_equal("crowded", grid, q, qm)
    log(f"K1 range_nn1, crowded: {int(qm.sum())} live queries, "
        f"{int(kn1)} unresolved; flags, count, ids and distances equal "
        f"(tolerance 0), masked queries resolved at (0, inf)")

    ks = seg_cuda._seg_stats_kernel(grid, qm, KNN_NORMALS)
    ps = seg_cuda.seg_stats_plain(fresh(), qm, KNN_NORMALS)
    err, min_dot = stats_check(ks, ps, h, qm, "K3 crowded")
    masked_row = torch.zeros(16, device=dev)
    masked_row[1] = float(h) * float(h)
    require(bool((ks[gone] == masked_row).all()),
            "K3 crowded: a masked query's row is not (0, h^2, 0, ...)")
    log(f"K3 seg_stats, crowded: t2 and counts equal, moments within 1e-5 "
        f"relative (largest difference {err:.3g}), normals min |n.n'| "
        f"{min_dot:.8f}, masked rows (0, h^2, 0...) on both branches")

    t2, nrm = ks[:, 1], seg_cuda.normals_from_stats(ks)
    seed_idx, qall, inv, h2, state = propagation_inputs(grid, qm, nrm, t2, 2)
    for adopt in (False, True):
        sk, ck = seg_cuda._prop_round_kernel(grid, qall, qm, state, inv, h2,
                                             adopt)
        sp, cp = seg_cuda.prop_round_plain(fresh(), qall, qm, state, inv, h2,
                                           adopt)
        require(bool((sk == sp).all()),
                f"K4 crowded (adopt={adopt}): state rows differ")
        require(int(ck) == int(cp), f"K4 crowded (adopt={adopt}): change "
                f"counts {int(ck)} != {int(cp)}")
    kl, kr4 = seg_cuda._propagate_kernel(grid, nrm, t2, qm, seed_idx, SV, 256)
    pl, pr4 = seg_cuda.propagate_rounds_plain(fresh(), nrm, t2, qm, seed_idx,
                                              SV, 256)
    require(kr4 == pr4 and bool((kl == pl).all()),
            "K4 crowded: the whole loop differs from the plain loop")
    require(bool((kl[gone] == -1).all()),
            "K4 crowded: a masked query was labelled")
    log(f"K4 prop_round, crowded: state rows and change counts of a round "
        f"equal in both modes, the whole loop's labels and {kr4} rounds "
        f"equal to the plain loop's (tolerance 0) on both branches")


def k5_phase(seed: int) -> dict:
    """K5 against its plain version on the pair's two reduced epochs, with
    masks and exact ties, and the DT-init percentile through both; then at
    the shape of the stage-1 rescue (a gathered query subset, no masks,
    targets at the sentinel), with every query masked, and with fewer
    queries than one block."""
    import torch

    from piecewise_icp_torch.ops import nn_cuda
    from piecewise_icp_torch.ops.preprocess import (percentile_c2c,
                                                    percentile_of)

    dev = torch.device("cuda")
    t_np, q_np = smoke_epochs(seed)
    mrng = np.random.default_rng(seed + 1)
    dup = mrng.choice(len(t_np) - 100, 100, replace=False)
    t_np[-100:] = t_np[dup]                          # 100 exact duplicates
    t = torch.from_numpy(t_np).to(dev)
    q = torch.from_numpy(q_np).to(dev)
    tm = torch.from_numpy(mrng.uniform(size=len(t_np)) > 0.01).to(dev)
    qm = torch.from_numpy(mrng.uniform(size=len(q_np)) > 0.4).to(dev)

    ki, kd2 = nn_cuda._nn1_brute_kernel(q, t, qm, tm)
    pi, pd2 = nn_cuda.nn1_brute_plain(q, t, qm, tm)
    torch.cuda.synchronize()
    require(bool((ki == pi).all()), "K5: nearest ids differ")
    require(bool((kd2 == pd2).all()), "K5: squared distances differ")
    require(bool((ki[~qm] == -1).all()), "K5: masked query matched")
    require(bool(tm[ki[qm]].all()), "K5: masked target matched")
    kd, pd = torch.sqrt(kd2[qm]), torch.sqrt(pd2[qm])
    err = max_abs(kd, pd)
    pct_k = percentile_c2c(t, q, 0.75, t_mask=tm, s_mask=qm)
    pct_p = percentile_of(torch.sqrt(torch.clamp(pd2, min=0.0)), 0.75)
    require(pct_k == pct_p, f"K5: percentile {pct_k} != plain {pct_p}")
    nq, nt = q.shape[0], t.shape[0]
    live_pairs = int(qm.sum()) * int(tm.sum())
    res = dict(
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda._nn1_brute_kernel(q, t, qm, tm)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_brute_plain(q, t, qm, tm)),
        **nn1_brute_bound(nq, nt, live_pairs, True, True))
    log(f"K5 nn1_brute {nq} x {nt} ({int(qm.sum())} "
        f"queries and {int(tm.sum())} targets unmasked, 100 duplicated "
        f"targets): ids and squared distances equal (tolerance 0); 75th "
        f"percentile {pct_k:.9g} m on both; kernel {res['ms']:.3f} ms, "
        f"plain (chunked brute) {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.3f} ms ({live_pairs} pairs)")

    # the stage-1 rescue: a gathered subset of the queries, no masks, some
    # targets moved to the sentinel
    sel = torch.from_numpy(np.sort(mrng.choice(nq, N_RESCUE, replace=False))
                           ).to(dev)
    qs = q[sel]
    ts = t.clone()
    ts[torch.from_numpy(mrng.choice(nt, 2000, replace=False)).to(dev)] = 1e30
    ki, kd2 = nn_cuda._nn1_brute_kernel(qs, ts)
    pi, pd2 = nn_cuda.nn1_brute_plain(qs, ts)
    torch.cuda.synchronize()
    require(bool((ki == pi).all()), "K5 rescue shape: nearest ids differ")
    require(bool((kd2 == pd2).all()),
            "K5 rescue shape: squared distances differ")
    require(bool((ts[ki, 0] < 1e29).all()),
            "K5 rescue shape: a sentinel target was matched")
    ms_r = time_ms(lambda: nn_cuda._nn1_brute_kernel(qs, ts))
    plain_r = time_ms(lambda: nn_cuda.nn1_brute_plain(qs, ts))
    bound_r = nn1_brute_bound(N_RESCUE, nt, N_RESCUE * (nt - 2000), False,
                              False)["bound_ms"]
    log(f"K5 nn1_brute, rescue shape {N_RESCUE} x {nt} (no masks, 2000 "
        f"targets at the sentinel): ids and squared distances equal "
        f"(tolerance 0); kernel {ms_r:.3f} ms, plain {plain_r:.3f} ms, "
        f"bound {bound_r:.3f} ms")

    # no live query at all, and fewer queries than one block
    none = torch.zeros(nq, dtype=torch.bool, device=dev)
    ki, kd2 = nn_cuda._nn1_brute_kernel(q, t, none, tm)
    require(bool((ki == -1).all()) and bool(torch.isinf(kd2).all()),
            "K5: a masked query was answered")
    ki, kd2 = nn_cuda._nn1_brute_kernel(q[:100].contiguous(), t, None, tm)
    pi, pd2 = nn_cuda.nn1_brute_plain(q[:100], t, None, tm)
    torch.cuda.synchronize()
    require(bool((ki == pi).all()) and bool((kd2 == pd2).all()),
            "K5, 100 queries: differs from the plain version")
    log("K5 nn1_brute: every query masked gives (inf, -1); 100 queries "
        "(under one block) equal the plain version (tolerance 0)")
    return res


def k6_check(label: str, q, t, k: int, epilogue: str, t_mask=None,
             library: bool = False) -> dict:
    """K6 against its plain version on the card at tolerance 0 (the same
    bits), with the target mask the path hands it: the k squared
    distances, then the path's epilogue; the
    kernel's time (median of 5), the plain version's (one call), the bound
    from these inputs and, where ``library``, one call of chunked
    ``torch.cdist`` (direct mode) + ``topk``, which the port never calls.
    The layout the library launches at this shape (blocks, and the warps
    that split the targets of a query, sharing its bound) is printed and
    returned.
    These launches are comparisons: callers read their path's counts
    before."""
    import torch

    from bench_torch import library_knn
    from piecewise_icp_torch.ops import nn_cuda

    for ep in ("d2", epilogue):
        kern = nn_cuda._knn_brute_kernel(q, t, k, t_mask, ep)
        plain = nn_cuda.knn_brute_plain(q, t, k, t_mask, ep)
        torch.cuda.synchronize()
        require(kern.shape == plain.shape and torch.equal(
            kern.view(torch.int32), plain.view(torch.int32)),
            f"K6 ({label}, {ep}): differs from the plain version")
    finite = torch.isfinite(plain)
    nq, nt = q.shape[0], t.shape[0]
    live = nt if t_mask is None else int(t_mask.sum())
    lay = nn_cuda.knn_brute_layout(nq, nt, k)
    res = dict(
        slices=lay["slices"], blocks=lay["blocks"],
        max_abs_err=max_abs(kern[finite], plain[finite]),
        ms=time_ms(lambda: nn_cuda._knn_brute_kernel(q, t, k, t_mask,
                                                     epilogue)),
        plain_ms=time_ms(lambda: nn_cuda.knn_brute_plain(q, t, k, t_mask,
                                                         epilogue),
                         reps=1, warmup=False),
        **knn_brute_bound(nq, nt, nq * live, t_mask is not None,
                          1 if epilogue == "sor_mean" else k))
    if library:
        res["library_ms"] = time_ms(lambda: library_knn(q, t, k), reps=1,
                                    warmup=False)
    lib_ms = ("not timed" if res["library_ms"] is None
              else f"{res['library_ms']:.3f} ms")
    log(f"K6 knn_brute, {label}: {nq} x {nt}, k = {k}; {lay['blocks']} "
        f"blocks of {lay['warps']} warps, {lay['qpw']} queries a warp, each "
        f"query's list held by {lay['slices']} warp(s) splitting the "
        f"targets: squared distances "
        f"and the {epilogue} epilogue equal the plain version (tolerance "
        f"0); kernel {res['ms']:.3f} ms, plain (chunked sqdist + topk) "
        f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}): {100 * res['bound_ms'] / res['ms']:.1f}% of "
        f"it; torch.cdist (direct mode) + topk, chunked: {lib_ms}")
    return res


def resolution_check(seed: int) -> dict:
    """estimate_resolution on the card against a float64 KD-tree: one K6
    launch, no plain version on the card; then K6 at its shape (n x n,
    k = 2, the all-true target mask it passes) against its plain
    version."""
    import torch
    from scipy.spatial import cKDTree

    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.preprocess import estimate_resolution
    from piecewise_icp_torch.utils.synth import terrain_cloud

    pts = terrain_cloud(np.random.default_rng(seed), n_side=N_SIDE,
                        extent=EXTENT)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    got = estimate_resolution(torch.from_numpy(pts).to("cuda"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    require(launches == {"knn_brute": 1} and not _cuda.PLAIN_ON_CUDA,
            f"estimate_resolution: launches {launches}, plain versions on "
            f"CUDA {dict(_cuda.PLAIN_ON_CUDA)}")
    d, _ = cKDTree(pts.astype(np.float64)).query(pts.astype(np.float64), k=2)
    want = float(d[:, 1].mean())
    rel = abs(got - want) / want
    log(f"resolution: {got:.9g} m on the card vs {want:.9g} m (float64 "
        f"KD-tree), relative {rel:.2e} (bound 1e-5); {dt:.3f} s for "
        f"{len(pts)} points; launches {launches}")
    require(rel <= 1e-5, "estimate_resolution differs from the KD-tree")
    p = torch.from_numpy(pts).to("cuda")
    return k6_check("resolution estimation", p, p, 2, "dist",
                    t_mask=torch.ones(p.shape[0], dtype=torch.bool,
                                      device="cuda"))


def unified_rescue_inputs(seed: int):
    """The unified SOR rescue's inputs on the smoke pair's first cloud
    (what ``preprocess_segment_device`` hands K6): the queries K2 leaves
    unresolved on the grid of the voxelised, centred cloud (at most the
    rescue budget, 4,096), and every point."""
    import torch

    from piecewise_icp_torch.models.segmentation_device import _seg_h
    from piecewise_icp_torch.ops import nn_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
    from piecewise_icp_torch.ops.preprocess import (_SOR_RESCUE,
                                                    voxel_downsample)

    c1, _, _ = smoke_pair(seed)
    down = voxel_downsample(c1, RES).astype(np.float64)
    pts = (down - down.mean(axis=0)).astype(np.float32)
    grid = CellGrid.from_index(build_grid(pts, _seg_h(KNN_NORMALS, RES)),
                               torch.device("cuda"))
    all_q = torch.ones(grid.n, dtype=torch.bool, device="cuda")
    _, _, resolved = nn_cuda.knn_sorted(grid, all_q, SOR_K + 1)
    bad = torch.nonzero(~resolved).squeeze(1)
    log(f"unified SOR rescue: {bad.shape[0]} of {grid.n} queries "
        f"unresolved on the grid of h = {grid.h:.4f} m (budget "
        f"{_SOR_RESCUE})")
    require(0 < bad.shape[0] <= _SOR_RESCUE,
            "unified SOR rescue: no query, or more than the budget, left "
            "to K6")
    return grid.points[bad], grid.points


def unified_rescue_check(seed: int) -> dict:
    """K6 at the unified SOR rescue's shape (``unified_rescue_inputs``),
    k + 1 = 15, the SOR mean, against its plain version."""
    q, t = unified_rescue_inputs(seed)
    return k6_check("unified SOR rescue", q, t, SOR_K + 1, "sor_mean",
                    library=True)


# ---------------------------------------------------------------------------
# pair phase
# ---------------------------------------------------------------------------


def pair_phase(seed: int) -> dict:
    """One registration through the user entry point, then warm repeats."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.io import formats, read_pcd, write_pcd

    c1, c2, t_true = smoke_pair(seed)
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
        # no device argument: the default has to be the card
        ok = pwt.piecewise_icp_pair_call(str(conf), out_prefix)
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
    mean, mx = truth_mm(t_est, t_true, c2)
    log(f"pair: residual displacement vs truth mean {mean:.4f} mm, max "
        f"{mx:.4f} mm (bounds 2 mm / 5 mm)")
    require(mean < 2.0 and mx < 5.0, "pair result outside the truth bounds")
    for name in PAIR_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the pair path")
    require(not plain_on_cuda,
            f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    log(f"pair: launches {launches}; plain versions on CUDA: none")

    warm, res = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = register_pair(pts1, pts2, cfg)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    profile_run(lambda: register_pair(pts1, pts2, cfg), "warm pair")
    core = res.core
    log(f"pair: cold {cold_s:.3f} s (entry point, PCD in / report out), "
        f"warm register_pair median of 3 {statistics.median(warm):.3f} s "
        f"({', '.join(f'{w:.3f}' for w in warm)}); patches "
        f"{core.num_patches}; outer iterations {core.iterations}; "
        f"inner ICP iterations {core.total_icp_iters}; guard fired "
        f"{res.guard_draws > 1} ({res.guard_draws} draws); source points "
        f"{len(pts2)}")
    return launches


def staged_pair_phase(seed: int) -> dict:
    """A 3,600-point pair, under the unified path's 4,096-point floor:
    the staged path (SOR, then segmentation) on the card."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.utils.synth import make_pair

    c1, c2, t_true = make_pair(np.random.default_rng(seed), PARAMS,
                               n_side=60, extent=EXTENT)
    cfg = pwt.PiecewiseICPConfig(res1=0.022, res2=0.022, svsize1=0.22,
                                 svsize2=0.22)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    res = register_pair(c1, c2, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    require(not _cuda.PLAIN_ON_CUDA,
            f"plain versions ran on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
    for name in ("range_nn1", "seg_stats", "prop_round", "propagate"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the staged path")
    mean, mx = truth_mm(res.trans_mat, t_true, c2)
    log(f"staged pair ({len(c1)} points): residual vs truth mean "
        f"{mean:.4f} mm, max {mx:.4f} mm (bounds 2 mm / 5 mm); {wall:.3f} s;"
        f" patches {res.core.num_patches}; guard draws {res.guard_draws}; "
        f"launches {launches}")
    require(mean < 2.0 and mx < 5.0, "staged pair outside the truth bounds")
    return launches


def _with_sparse_points(rng: np.random.Generator,
                        pts: np.ndarray) -> np.ndarray:
    """``pts`` and N_SPARSE isolated points above it, thinning out with
    height (mean spacing ~0.1 m: none has 14 neighbours within a few cm)."""
    z0 = float(pts[:, 2].max()) + 0.2
    sparse = np.stack([rng.uniform(0.0, EXTENT, N_SPARSE),
                       rng.uniform(0.0, EXTENT, N_SPARSE),
                       z0 + rng.exponential(1.0, N_SPARSE)], axis=1)
    return np.concatenate([pts, sparse.astype(np.float32)])


def _exact_sor_keep(pts: np.ndarray, k: int, mult: float) -> np.ndarray:
    """The SOR decision from a float64 KD-tree: mean distance to the k
    nearest non-self neighbours within mean + mult * sample std."""
    from scipy.spatial import cKDTree

    p = pts.astype(np.float64)
    d, _ = cKDTree(p).query(p, k=k + 1)
    mean_d = d[:, 1:].mean(axis=1)
    return mean_d <= mean_d.mean() + mult * mean_d.std(ddof=1)


def sparse_staged_phase(seed: int) -> dict:
    """Full-width epochs with N_SPARSE isolated points each: more unresolved
    SOR queries than the unified path's budget, so it declines and the
    staged SOR re-measures every unresolved query on the card (K6).  Also
    the staged SOR of a cloud no grid fits (one point 10 km away): the
    brute k-NN on the card (K6 at n x n), held against its plain version
    at that shape, whose numbers it returns."""
    import torch
    from scipy.spatial import cKDTree

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.models.segmentation_device import _seg_h
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.preprocess import (_SOR_RESCUE,
                                                    sor_keep_mask_device,
                                                    voxel_downsample)
    from piecewise_icp_torch.utils.synth import make_pair

    rng = np.random.default_rng(seed + 3)
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=N_SIDE, extent=EXTENT)
    s1, s2 = _with_sparse_points(rng, c1), _with_sparse_points(rng, c2)
    mult = 2.7
    down = voxel_downsample(s1, RES)
    d15, _ = cKDTree(down.astype(np.float64)).query(
        down.astype(np.float64), k=SOR_K + 1)
    h_unified = _seg_h(KNN_NORMALS, RES)
    h_staged = max(1.5 * np.sqrt((SOR_K + 1) / np.pi), 4.0) * RES
    n_bad_u = int((d15[:, -1] > h_unified).sum())
    n_bad_s = int((d15[:, -1] > h_staged).sum())
    log(f"sparse staged: {len(down)} points after voxelisation, of which "
        f"{n_bad_u} / {n_bad_s} have their {SOR_K + 1}th neighbour beyond "
        f"the unified / staged SOR cell size (budget {_SOR_RESCUE})")
    require(n_bad_u > _SOR_RESCUE, "sparse staged: the unified path would "
            "not decline this cloud")

    for label, cloud in (("grid", down),
                         ("no grid", np.concatenate(
                             [down, np.full((1, 3), 1e4, np.float32)]))):
        _cuda.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = sor_keep_mask_device(cloud, RES, SOR_K, mult,
                                    torch.device("cuda"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        require(not _cuda.PLAIN_ON_CUDA, f"sparse staged ({label}): plain "
                f"versions ran on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
        want = _exact_sor_keep(cloud, SOR_K, mult)
        agree = float((keep == want).mean())
        removed_sparse = int((~keep[cloud[:, 2] > c1[:, 2].max() + 0.1])
                             .sum())
        log(f"sparse staged SOR ({label}) of {len(cloud)} points on the "
            f"card: {dt:.3f} s; keeps {int(keep.sum())}, agrees with the "
            f"float64 KD-tree SOR on {100 * agree:.4f}% (bound 99.9%); "
            f"removes {removed_sparse} of the points above the surface; "
            f"launches {launches}")
        require(agree >= 0.999, f"sparse staged SOR ({label}) differs from "
                "the exact statistic")
        if label == "grid":
            require(launches.get("knn_sorted", 0) > 0
                    and launches.get("knn_brute", 0) == 1,
                    "sparse staged SOR: K2 and one rescue by K6 were not "
                    "launched")
        else:
            require(launches == {"knn_brute": 1}, "sparse staged SOR (no "
                    "grid): not the brute k-NN alone (K6)")
            require(not keep[-1], "sparse staged SOR (no grid): the far "
                    "point was kept")
            nogrid = torch.from_numpy(cloud).to("cuda")
    # sor_filter_mask hands K6 an all-true target mask
    k6 = k6_check("no-grid SOR (n x n)", nogrid, nogrid, SOR_K + 1, "dist",
                  t_mask=torch.ones(nogrid.shape[0], dtype=torch.bool,
                                    device="cuda"))

    cfg = pwt.PiecewiseICPConfig()
    _cuda.reset_counts()
    t0 = time.perf_counter()
    res = register_pair(s1, s2, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    require(not _cuda.PLAIN_ON_CUDA,
            f"plain versions ran on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
    # two declined unified SORs and two staged ones (each re-measuring its
    # unresolved queries by K6), then segmentation
    require(launches.get("knn_sorted", 0) >= 4
            and launches.get("knn_brute", 0) >= 2,
            f"sparse staged pair: the staged SOR did not run on the card "
            f"({launches})")
    for name in ("range_nn1", "seg_stats", "prop_round", "propagate"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the sparse staged pair")
    mean, mx = truth_mm(res.trans_mat, t_true, c2)
    log(f"sparse staged pair ({len(s1)} points): residual vs truth mean "
        f"{mean:.4f} mm, max {mx:.4f} mm (bounds 2 mm / 5 mm); {wall:.3f} s;"
        f" patches {res.core.num_patches}; guard draws {res.guard_draws}; "
        f"launches {launches}")
    require(mean < 2.0 and mx < 5.0,
            "sparse staged pair outside the truth bounds")
    return k6


# ---------------------------------------------------------------------------
# BASELINE configurations 3 and 4: the rockfall series at full scale
# ---------------------------------------------------------------------------


class _PortLog(logging.Handler):
    """The port's log messages while attached to its logger (what path a
    cloud took, the rescues, the refine, the guard's decisions)."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.msgs: list = []

    def emit(self, record: logging.LogRecord) -> None:
        self.msgs.append(record.getMessage())

    def found(self, pattern: str) -> list:
        """The groups of every message that ``pattern`` matches."""
        return [m.groups() for m in map(re.compile(pattern).match, self.msgs)
                if m]


def corner_gap(t_a: np.ndarray, t_b: np.ndarray, pts: np.ndarray) -> float:
    """Largest distance (m) between the corners of the box of ``pts`` moved
    by the two transforms."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = np.array([[(lo, hi)[b][i] for i, b in enumerate(k)]
                  for k in np.ndindex(2, 2, 2)], np.float64)
    c = np.c_[c, np.ones(8)]
    return float(np.linalg.norm((c @ t_a.T - c @ t_b.T)[:, :3],
                                axis=1).max())


def _truth_err(t_est: np.ndarray, t_true: np.ndarray):
    """Largest parameter error against the truth: (mgon, mm), as the
    rockfall runner reports it."""
    from piecewise_icp_torch.ops.transform import matrix_to_params_gon

    err = matrix_to_params_gon(t_est) - matrix_to_params_gon(t_true)
    return 1e3 * float(np.abs(err[:3]).max()), \
        1e3 * float(np.abs(err[3:]).max())


def rockfall_phase(seed: int) -> dict:
    """BASELINE configurations 3 and 4 on the rockfall series at the
    reference's scale (6 epochs of a 150 m x 100 m slope at 0.3 m, seed 7;
    ``seed`` is not used): the pair of epochs 1 and 2 through
    ``register_pair`` with no ``device`` (its path, patches, iterations,
    refine, truth error and warm time; its transform within 0.5 mm at the
    source's box corners of the JAX package's, ``JAX_ROCKFALL_PAIR``), the
    same pair with the acceptance guard firing, and the Kalman-smoothed 4D
    campaign through ``piecewise_icp_4d_call`` from the file the port
    writes; the launches of the phase (K1-K4 and K6 required, no plain
    version on a CUDA tensor).  Then K1-K6 against their plain versions at
    this path's shapes.  Returns each kernel's numbers at these shapes.

    The pair's transform and VCM are printed as digests of their bytes, its
    SOR's device time (``prep.sor.device``) a warm pair: two trees compare
    from their lines."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.io import formats, read_pcd
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.preprocess import (_SOR_RESCUE,
                                                    voxel_downsample)
    from piecewise_icp_torch.utils import rockfall
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER
    from piecewise_icp_torch.utils.logging import log as port_log

    t_phase = time.perf_counter()
    rec = _PortLog()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scans = rockfall.generate_rockfall(
            tmp, ROCKFALL_EPOCHS, seed=ROCKFALL_SEED, extent=ROCKFALL_EXTENT,
            res=ROCKFALL_RES)
        gen_s = time.perf_counter() - t0
        files = sorted(os.listdir(scans))
        pts1, pts2 = (read_pcd(os.path.join(scans, f)) for f in files[:2])
        gt_file = os.path.join(tmp, "defined_transformations.txt")
        _, gt = formats.read_ground_truth_transforms(gt_file)
        cfg = rockfall.rockfall_config(scans, tmp + "/")
        down = [len(voxel_downsample(p, ROCKFALL_RES)) for p in (pts1, pts2)]
        log(f"rockfall: {ROCKFALL_EPOCHS} epochs of a {ROCKFALL_EXTENT} m "
            f"slope at {ROCKFALL_RES} m (seed {ROCKFALL_SEED}) written in "
            f"{gen_s:.2f} s: {files[0]}, ...; the pair has {len(pts1)} / "
            f"{len(pts2)} points, {down[0]} / {down[1]} after the voxel grid")

        def pair(c):
            """``register_pair`` of epochs 1 and 2 on the card (no device
            named), its seconds, the port's log messages kept in ``rec``."""
            rec.msgs.clear()
            port_log.addHandler(rec)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = register_pair(pts1, pts2, c, sor_mult=c.sor_std_mult_pair)
                torch.cuda.synchronize()
                return r, time.perf_counter() - t0
            finally:
                port_log.removeHandler(rec)

        # ---- configuration 3, the first call of the phase ----
        _cuda.reset_counts()
        res3, cold_s = pair(cfg)
        declined = [int(n) for (n,) in rec.found(
            r"unified SOR: (\d+) unresolved > budget")]
        rescued = [int(n) for (n,) in rec.found(
            r"device SOR: (\d+) unresolved queries re-measured")]
        selected = rec.found(r"selected patches: (\d+) / (\d+)")
        refine = rec.found(r"robust refine: (\d+)/(\d+) stable patches "
                           r"rejected .*\|dT\|=(\S+) mm")
        core = res3.core
        t3 = res3.trans_mat
        require(t3.shape == (4, 4) and np.isfinite(t3).all()
                and np.isfinite(res3.vcm).all(),
                "rockfall pair: transform or VCM not finite")
        rot, tr = _truth_err(t3, gt[1])
        gap = corner_gap(t3, JAX_ROCKFALL_PAIR, pts2)
        log(f"rockfall pair (configuration 3): the unified path declined "
            f"{len(declined)} of 2 clouds, {declined} unresolved SOR queries "
            f"against its budget of {_SOR_RESCUE}; the staged SOR then "
            f"re-measured {rescued} on the card; supervoxels selected as "
            f"patches {selected}; patches in the core {core.num_patches}; "
            f"outer iterations {core.iterations}, inner ICP iterations "
            f"{core.total_icp_iters}; robust refine (rejected / stable, "
            f"|dT| mm) {refine}; stable ratio {core.stable_ratio:.4f}; "
            f"guard draws {res3.guard_draws}")
        log(f"rockfall pair: error against the truth {rot:.4f} mgon, "
            f"{tr:.4f} mm (the JAX package's report: 0.55 mgon, 2.571 mm on "
            f"the TPU); {1e3 * gap:.6f} mm off the JAX package's transform "
            f"at the source's box corners (bound 0.5 mm); VCM diagonal "
            f"{np.diag(res3.vcm).tolist()}")
        require(len(declined) == 2 and min(declined) > _SOR_RESCUE,
                f"rockfall pair: the unified path did not decline both "
                f"clouds ({declined})")
        require(len(rescued) == 2, "rockfall pair: the staged SOR did not "
                f"re-measure unresolved queries on both clouds ({rescued})")
        require(gap < 5e-4, f"rockfall pair: {1e3 * gap:.4f} mm off the JAX "
                "package's transform at the box corners")
        log(f"rockfall pair: transform bytes sha256 "
            f"{hashlib.sha256(t3.tobytes()).hexdigest()[:16]}, VCM "
            f"{hashlib.sha256(res3.vcm.tobytes()).hexdigest()[:16]}")
        warm, sor_dev = [], []
        for _ in range(3):
            GLOBAL_TIMER.records.clear()
            warm.append(pair(cfg)[1])
            sor_dev.append(GLOBAL_TIMER.summary().get("prep.sor.device",
                                                      0.0))
        busy = profile_run(lambda: pair(cfg), "rockfall warm pair")
        log(f"rockfall pair: cold {cold_s:.3f} s, warm median of 3 "
            f"{statistics.median(warm):.3f} s "
            f"({', '.join(f'{w:.3f}' for w in warm)}); prep.sor.device "
            f"(both clouds, the declined unified SOR and the staged one) "
            f"median {1e3 * statistics.median(sor_dev):.1f} ms "
            f"({', '.join(f'{1e3 * v:.1f}' for v in sor_dev)}); profiled "
            f"warm pair device busy {100 * busy:.1f}%")

        # ---- the same pair with the acceptance guard firing ----
        resg, guard_s = pair(rockfall.rockfall_config(
            scans, tmp + "/", guard_stable_ratio=ROCKFALL_GUARD_RATIO))
        probe = rec.found(r"acceptance guard: (draw disagreement|draws "
                          r"agree) \(?(\S+) sigma")
        fused = rec.found(r"acceptance guard: GLS-fused draws (\[.*\]) of "
                          r"(\d+)")
        rot_g, tr_g = _truth_err(resg.trans_mat, gt[1])
        log(f"rockfall pair, guard at a stable ratio of "
            f"{ROCKFALL_GUARD_RATIO}: {resg.guard_draws} draws; probe "
            f"{probe} (escalation above {cfg.guard_escalate_z} sigma); "
            f"fused by sigma0 {fused}; error against the truth "
            f"{rot_g:.4f} mgon, {tr_g:.4f} mm; "
            f"{1e3 * corner_gap(resg.trans_mat, t3, pts2):.4f} mm from the "
            f"unguarded pair at the box corners; {guard_s:.3f} s")
        require(resg.guard_draws > 1 and np.isfinite(resg.trans_mat).all(),
                "rockfall pair: the acceptance guard did not fire")

        # ---- configuration 4: the Kalman-smoothed 4D campaign ----
        out = pathlib.Path(tmp) / "out_mode-1"
        conf = os.path.join(tmp, "config_4d.txt")
        rockfall.rockfall_config(scans, str(out) + "/").to_reference_file(
            conf)
        GLOBAL_TIMER.records.clear()
        t0 = time.perf_counter()
        ok = pwt.piecewise_icp_4d_call(
            conf, 0, ROCKFALL_EPOCHS, -1, overlap_thd=0.75,
            ground_truth=gt_file, device="cuda", kalman_enabled=True,
            **rockfall.FILE_OVERRIDES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        plain_on_cuda = dict(_cuda.PLAIN_ON_CUDA)
        require(ok, "rockfall 4d: piecewise_icp_4d_call returned False")
        for name in OUTPUTS_4D:
            require((out / name).exists(), f"rockfall 4d: {name} missing")
        stamps = [int(f.split("- ")[1][:6]) for f in files]
        for ts in stamps[1:]:
            require((out / f"{ts}_Adaptive_TransMatrix.txt").exists(),
                    f"rockfall 4d: pair report of {ts} missing")
        plan = formats.read_reg_pairs(out / "RegPairFile.txt")
        ts_rows, _, _ = formats.read_trans_matrices(
            out / "TransMatrices_toRef.txt", ROCKFALL_EPOCHS - 1)
        require(ts_rows == stamps[1:] and stamps == sorted(stamps),
                f"rockfall 4d: rows {ts_rows}, not the files' timestamps "
                f"in time order {stamps[1:]}")
        require(sorted(plan) == list(range(1, ROCKFALL_EPOCHS))
                and all(0 <= t < s for s, t in plan.items()),
                f"rockfall 4d: plan {plan}")
        errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
        smoothed = formats.read_abs_errors(
            out / "TransPara_AbsError_smoothed.txt")
        for e in (errors, smoothed):
            require(e.shape == (ROCKFALL_EPOCHS - 1, 6)
                    and np.isfinite(e).all(), "rockfall 4d: bad error table")
        phases = [json.loads(ln) for ln in
                  (out / "phase_timings.jsonl").read_text().splitlines()]
        pair_s = [r["seconds"] for r in phases if r["phase"] == "pair"]
        plan_s = sum(r["seconds"] for r in phases
                     if r["phase"] == "pair_planning")
        digest = {name: hashlib.sha256((out / name).read_bytes())
                  .hexdigest()[:16] for name in REPRO_TABLES}
        k5_calls = collections.Counter(
            r["phase"] for r in GLOBAL_TIMER.records
            if r["phase"] == K5_RESCUE_PHASE or r["phase"] in K5_OTHER_PHASES)
    log(f"rockfall 4d (configuration 4): plan (source: target, epochs from "
        f"0) {plan}, rows {ts_rows}; chained errors mean "
        f"{errors[:, :3].mean(0).round(3).tolist()} mgon, "
        f"{errors[:, 3:].mean(0).round(4).tolist()} mm, max "
        f"{float(errors[:, :3].max())!r} mgon, "
        f"{float(errors[:, 3:].max())!r} mm; smoothed mean "
        f"{smoothed[:, :3].mean(0).round(3).tolist()} mgon, "
        f"{smoothed[:, 3:].mean(0).round(4).tolist()} mm, max "
        f"{float(smoothed[:, :3].max())!r} mgon, "
        f"{float(smoothed[:, 3:].max())!r} mm "
        f"(the JAX package's report on the TPU: mean tx 9.561 mm, max "
        f"16.644 mm); table digests {digest}")
    log(f"rockfall 4d: {wall:.3f} s for {ROCKFALL_EPOCHS} epochs "
        f"({wall / ROCKFALL_EPOCHS:.3f} s/epoch); from phase_timings.jsonl: "
        f"planning {plan_s:.3f} s, pair phases {sum(pair_s):.3f} s "
        f"({sum(pair_s) / len(pair_s):.3f} s a pair, "
        f"{(plan_s + sum(pair_s)) / ROCKFALL_EPOCHS:.3f} s/epoch with "
        f"planning); calls of the brute 1-NN by phase {dict(k5_calls)}")
    log(f"rockfall: launches of the phase (configuration 3 cold, 3 warm, "
        f"profiled, guarded, configuration 4) {launches}; plain versions on "
        f"CUDA: "
        f"{plain_on_cuda or 'none'}")
    for name in ROCKFALL_KERNELS:
        require(launches.get(name, 0) > 0,
                f"rockfall: kernel {name} was not launched")
    require(not plain_on_cuda,
            f"rockfall: plain versions ran on CUDA tensors: {plain_on_cuda}")
    results = rockfall_kernels(res3, pts1, pts2, cfg.svsize1)
    for name in REPLACES:
        results.setdefault(name, {})["launches"] = int(
            launches.get(name, 0))
    log(f"rockfall phase: {time.perf_counter() - t_phase:.1f} s")
    return results


def rockfall_rescue_inputs(pts1: np.ndarray):
    """The staged SOR's grid of the voxelised rockfall epoch and the
    queries K2 leaves unresolved on it, which K6 re-measures against the
    whole cloud."""
    import torch

    from piecewise_icp_torch.ops import nn_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
    from piecewise_icp_torch.ops.preprocess import voxel_downsample

    h_sor = max(1.5 * np.sqrt((SOR_K + 1) / np.pi), 4.0) * ROCKFALL_RES
    down = voxel_downsample(pts1, ROCKFALL_RES)
    sor_grid = CellGrid.from_index(build_grid(down, h_sor),
                                   torch.device("cuda"))
    all_q = torch.ones(sor_grid.n, dtype=torch.bool, device="cuda")
    _, _, resolved = nn_cuda.knn_sorted(sor_grid, all_q, SOR_K + 1)
    bad = sor_grid.points[torch.nonzero(~resolved).squeeze(1)]
    log(f"rockfall, staged SOR rescue: {bad.shape[0]} of {sor_grid.n} "
        f"queries unresolved on the grid of h = {h_sor:.3f} m")
    return sor_grid, bad


def rockfall_kernels(res3, pts1: np.ndarray, pts2: np.ndarray,
                     sv: float) -> dict:
    """K1-K6 against their plain versions at the rockfall path's shapes
    (the tolerances of the kernel phases): K2 on the staged SOR's grid of
    the voxelised target (the grid whose unresolved queries the staged SOR
    re-measures), K6 on those unresolved queries against the whole cloud
    (the SOR rescue), K3 and K4 on the
    segmentation grid of the prepared target,
    K1 at stage 1 (the source in cell order on the target's grid of 4 x
    res), K5 at adaptive planning's shape (an epoch against the one before,
    no mask: no grid of h = DTinit fits this extent)."""
    import torch

    from piecewise_icp_torch.models.piecewise_icp import _cell_order
    from piecewise_icp_torch.models.segmentation_device import _seg_h
    from piecewise_icp_torch.ops import nn_cuda
    from piecewise_icp_torch.ops.grid_nn import (MAX_GRID_CELLS, CellGrid,
                                                 build_grid)

    dev = torch.device("cuda")
    res = {}
    sor_grid, bad = rockfall_rescue_inputs(pts1)
    res["knn_sorted"] = knn_check(sor_grid, "rockfall, staged SOR grid")
    res["knn_brute"] = k6_check("rockfall staged SOR rescue", bad,
                                sor_grid.points, SOR_K + 1, "sor_mean",
                                library=True)
    target = res3.core.patches1.points
    res.update(seg_prop_checks(
        CellGrid.from_index(build_grid(target, _seg_h(KNN_NORMALS,
                                                      ROCKFALL_RES)), dev),
        sv, "rockfall, segmentation grid", determined_only=True))
    index1 = build_grid(target, 4.0 * ROCKFALL_RES)
    source = res3.core.patches2.points
    q = torch.from_numpy(source[_cell_order(source, index1)]).to(dev)
    res["range_nn1"] = range_nn1_check(
        "rockfall stage 1", CellGrid.from_index(index1, dev), q,
        torch.ones(q.shape[0], dtype=torch.bool, device=dev), reps=5)
    span = (pts1.max(axis=0) - pts1.min(axis=0)) / 0.1
    log(f"rockfall planning: a grid of h = DTinit = 0.1 m over the epoch "
        f"would hold {int(np.prod(np.floor(span) + 1)):,} cells (the cap is "
        f"{MAX_GRID_CELLS:,}): planning takes the brute 1-NN (K5)")
    t = torch.from_numpy(pts1).to(dev)
    q = torch.from_numpy(pts2).to(dev)
    ki, kd2 = nn_cuda._nn1_brute_kernel(q, t)
    pi, pd2 = nn_cuda.nn1_brute_plain(q, t)
    torch.cuda.synchronize()
    require(bool((ki == pi).all()), "K5 (rockfall planning): ids differ")
    require(bool((kd2 == pd2).all()),
            "K5 (rockfall planning): squared distances differ")
    nq, nt = q.shape[0], t.shape[0]
    res["nn1_brute"] = dict(
        max_abs_err=max_abs(torch.sqrt(kd2), torch.sqrt(pd2)),
        ms=time_ms(lambda: nn_cuda._nn1_brute_kernel(q, t)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_brute_plain(q, t), reps=1),
        **nn1_brute_bound(nq, nt, nq * nt, False, False))
    log(f"K5 nn1_brute, rockfall planning {nq} x {nt} (no masks): ids and "
        f"squared distances equal (tolerance 0); kernel "
        f"{res['nn1_brute']['ms']:.3f} ms, plain (chunked brute) "
        f"{res['nn1_brute']['plain_ms']:.3f} ms, bound "
        f"{res['nn1_brute']['bound_ms']:.3f} ms")
    return res


# ---------------------------------------------------------------------------
# reproducibility, ICP variants, change screen, exports and hooks, C ABI
# ---------------------------------------------------------------------------


def reproducible_phase(seed: int) -> None:
    """Two runs of one input give the same bits: the PatchSet of one smoke
    epoch (unified SOR + segmentation), and a whole registration of the
    smoke pair (where it differs, the first iteration whose packed stats
    differ is named).  A third registration under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` lists the
    operations PyTorch warns about and whether the result kept its bits
    (that mode also fills fresh memory with NaN): reported, not
    required."""
    import warnings

    import torch

    import piecewise_icp_torch as pwt
    # the module: the package's name ``piecewise_icp`` is the function
    core_mod = importlib.import_module(
        "piecewise_icp_torch.models.piecewise_icp")
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.models.segmentation_device import \
        preprocess_segment_device
    from piecewise_icp_torch.ops.preprocess import voxel_downsample
    from piecewise_icp_torch.ops.segment_ops import segment_sum

    c1, c2, _ = smoke_pair(seed)
    cfg = pwt.PiecewiseICPConfig()
    down = voxel_downsample(c1, RES)
    sets = []
    for _ in range(2):
        ps, nsv, kept = preprocess_segment_device(
            down, RES, SOR_K, cfg.sor_std_mult_pair, SV, KNN_NORMALS, cfg,
            device="cuda")
        sets.append(dict(ps.to_numpy(), kept=kept))
    diff = {f: bit_diff(sets[0][f], sets[1][f]) for f in sets[0]}
    log(f"reproducible: PatchSet of one smoke epoch ({len(down)} points "
        f"after voxelisation, {len(sets[0]['centroids'])} patches) built "
        f"twice: elements whose bits differ, by field {diff}")
    # what the fixed order costs: the second moments of the patches (the
    # widest of the six float segment sums a cloud makes) against a float
    # index_add_, which adds by atomics
    x = torch.from_numpy(sets[0]["points"]).to("cuda")
    ids = torch.from_numpy(sets[0]["labels"]).to("cuda").long()
    n_seg = len(sets[0]["centroids"])
    outer = (x[:, :, None] * x[:, None, :]).reshape(-1, 9)
    sink = torch.where(ids >= 0, ids, n_seg)
    fixed_ms = time_ms(lambda: segment_sum(outer, ids, n_seg))
    atomic_ms = time_ms(lambda: torch.zeros(
        n_seg + 1, 9, device="cuda").index_add_(0, sink, outer))
    log(f"reproducible: one segment sum of {len(x)} x 9 floats into "
        f"{n_seg} patches: fixed order {fixed_ms:.3f} ms, index_add_ "
        f"(atomics) {atomic_ms:.3f} ms (median of 5, CUDA events)")

    records: list = []
    step = core_mod._iteration_step

    def recording(*args, **kw):
        out = step(*args, **kw)
        records[-1].append(out[0].copy())
        return out

    core_mod._iteration_step = recording
    try:
        outs = []
        for _ in range(2):
            records.append([])
            outs.append(register_pair(c1, c2, cfg))
    finally:
        core_mod._iteration_step = step
    a, b = outs
    pair_diff = {"trans_mat": bit_diff(a.trans_mat, b.trans_mat),
                 "vcm": bit_diff(a.vcm, b.vcm)}
    for side in ("patches1", "patches2"):
        for f, v in getattr(a.core, side).to_numpy().items():
            n = bit_diff(v, getattr(getattr(b.core, side), f))
            if n:
                pair_diff[f"{side}.{f}"] = n
    first = next((i for i, (x, y) in enumerate(zip(*records))
                  if bit_diff(x, y)), None)
    where = ("every iteration's stats equal" if first is None else
             f"iteration {first + 1} is the first whose stats differ, in "
             f"entries {np.flatnonzero(records[0][first] != records[1][first]).tolist()}")
    log(f"reproducible: register_pair of the smoke pair twice "
        f"({len(records[0])} / {len(records[1])} iterations, guard draws "
        f"{a.guard_draws} / {b.guard_draws}): elements whose bits differ "
        f"{pair_diff}; {where}")

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det = register_pair(c1, c2, cfg)
    finally:
        torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).splitlines()[0][:150] for w in caught})
    log(f"reproducible: under torch.use_deterministic_algorithms(warn_only)"
        f" the transform's bits differ in {bit_diff(det.trans_mat, a.trans_mat)}"
        f" elements; {len(msgs)} distinct warnings: {msgs}")
    require(not any(diff.values()), f"reproducible: the PatchSet differs "
            f"between two runs: {diff}")
    require(not any(pair_diff.values()), f"reproducible: register_pair "
            f"differs between two runs: {pair_diff}; {where}")


def variants_phase(seed: int) -> None:
    """The smoke pair under the symmetric objective and under inverse-
    variance weights beside the reference objective: truth bounds, the
    pair path's kernels launched, no plain version on a CUDA tensor,
    iterations and the warm time (median of 3)."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda

    c1, c2, t_true = smoke_pair(seed)
    for label, over in (("reference", {}),
                        ("symmetric", dict(icp_variant="symmetric")),
                        ("inverse_variance",
                         dict(icp_weighting="inverse_variance"))):
        cfg = pwt.PiecewiseICPConfig(**over)
        _cuda.reset_counts()
        res = register_pair(c1, c2, cfg)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        require(not _cuda.PLAIN_ON_CUDA, f"variant {label}: plain versions "
                f"ran on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
        for name in PAIR_KERNELS:
            require(launches.get(name, 0) > 0,
                    f"variant {label}: kernel {name} was not launched")
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            register_pair(c1, c2, cfg)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        mean, mx = truth_mm(res.trans_mat, t_true, c2)
        log(f"variant {label}: residual vs truth mean {mean:.4f} mm, max "
            f"{mx:.4f} mm (bounds 2 mm / 5 mm); outer iterations "
            f"{res.core.iterations}, inner ICP iterations "
            f"{res.core.total_icp_iters}; guard draws {res.guard_draws}; "
            f"warm register_pair median of 3 "
            f"{statistics.median(warm):.3f} s "
            f"({', '.join(f'{w:.3f}' for w in warm)}); launches {launches}")
        require(mean < 2.0 and mx < 5.0,
                f"variant {label} outside the truth bounds")


# the change screen's scene: one square block of the source epoch, 15% of
# its area, raised 2 mm (below the 4 mm DTmin floor), as the leak of the
# JAX package's refine tests (tests/test_models.py, leak_frac 0.15)
CHANGE_FRAC = 0.15
CHANGE_MM = 2.0


def change_block(c2: np.ndarray) -> np.ndarray:
    """Mask of the changed block: a square of CHANGE_FRAC of the extent's
    area at the corner of the smallest x and y."""
    side = EXTENT * np.sqrt(CHANGE_FRAC)
    lo = c2[:, :2].min(axis=0)
    return ((c2[:, 0] < lo[0] + side) & (c2[:, 1] < lo[1] + side))


def change_screen_phase(seed: int) -> None:
    """The smoke pair with a coherent sub-LoD change in the source, with
    the refine off: the change screen must drop patches and the result must
    meet the truth bounds on the unchanged part."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda

    c1, c2, t_true = smoke_pair(seed)
    block = change_block(c2)
    c2c = c2.copy()
    c2c[block, 2] += np.float32(CHANGE_MM * 1e-3)
    res = {}
    for screen in (False, True):
        cfg = pwt.PiecewiseICPConfig(robust_refine=False,
                                     change_screen=screen)
        _cuda.reset_counts()
        t0 = time.perf_counter()
        res[screen] = register_pair(c1, c2c, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(not _cuda.PLAIN_ON_CUDA, "change screen: plain versions ran "
                f"on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
        for name in PAIR_KERNELS:
            require(_cuda.LAUNCHES.get(name, 0) > 0,
                    f"change screen: kernel {name} was not launched")
        r = res[screen]
        mean, mx = truth_mm(r.trans_mat, t_true, c2[~block])
        log(f"change screen {'on' if screen else 'off'} ({int(block.sum())} "
            f"of {len(c2)} source points raised {CHANGE_MM} mm): "
            f"final_n_stable {r.core.final_n_stable} of "
            f"{r.core.num_patches[1]} patches, stable ratio "
            f"{r.core.stable_ratio:.4f}; residual vs truth on the unchanged "
            f"part mean {mean:.4f} mm, max {mx:.4f} mm; tz "
            f"{1e3 * r.trans_mat[2, 3]:.4f} mm; {wall:.3f} s")
    require(res[True].core.final_n_stable < res[False].core.final_n_stable,
            "change screen: no patch was excluded")
    mean, mx = truth_mm(res[True].trans_mat, t_true, c2[~block])
    require(mean < 2.0 and mx < 5.0,
            "change screen: outside the truth bounds on the unchanged part")


def exports_hooks_phase(seed: int) -> None:
    """``isVisual: 1`` through the file entry point writes the four colored
    PCDs; ``PWICP_PROFILE_DIR`` yields a trace; ``PWICP_NO_UNIFIED=1`` runs
    the smoke pair through the staged path at full width."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.io import read_pcd, write_pcd
    from piecewise_icp_torch.models import pairwise
    from piecewise_icp_torch.ops import _cuda

    c1, c2, t_true = smoke_pair(seed)
    captured = []
    write_viz = pairwise.write_visualizations

    def capture(prefix, result):
        captured.append(result)
        write_viz(prefix, result)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_pcd(tmp / "Epoch_000.pcd", c1)
        write_pcd(tmp / "Epoch_001.pcd", c2)
        cfg = pwt.PiecewiseICPConfig(path1=str(tmp / "Epoch_000.pcd"),
                                     path2=str(tmp / "Epoch_001.pcd"),
                                     visual=True)
        conf = tmp / "config_pair.txt"
        cfg.to_reference_file(conf)
        prefix = str(tmp / "Vis_")
        pairwise.write_visualizations = capture
        try:
            ok = pwt.piecewise_icp_pair_call(str(conf), prefix)
        finally:
            pairwise.write_visualizations = write_viz
        require(ok, "isVisual: piecewise_icp_pair_call returned False")
        core = captured[0].core
        sizes = {}
        for name in ("TransMatrix.txt", "Patches1_colored.pcd",
                     "Patches2_colored.pcd", "StableUnstable2.pcd",
                     "ThreeClouds.pcd"):
            require((tmp / f"Vis_{name}").exists(), f"isVisual: {name} "
                    "missing")
            if name.endswith(".pcd"):
                sizes[name] = len(read_pcd(tmp / f"Vis_{name}"))
        want = {"Patches1_colored.pcd": len(core.patches1.points),
                "Patches2_colored.pcd": len(core.patches2.points),
                "StableUnstable2.pcd": len(core.patches2.points),
                "ThreeClouds.pcd": len(c1) + 2 * len(c2)}
        log(f"isVisual: the four views written, points {sizes} (patch sets "
            f"{want['Patches1_colored.pcd']} / "
            f"{want['Patches2_colored.pcd']})")
        require(sizes == want, f"isVisual: point counts {sizes} != {want}")

        os.environ["PWICP_PROFILE_DIR"] = str(tmp / "trace")
        try:
            pairwise.register_pair(c1, c2, pwt.PiecewiseICPConfig())
        finally:
            del os.environ["PWICP_PROFILE_DIR"]
        traces = sorted((tmp / "trace").glob("*.json"))
        require(len(traces) == 1, f"PWICP_PROFILE_DIR: traces {traces}")
        kb = traces[0].stat().st_size / 1024
        has_kernel = b"pwicp::" in traces[0].read_bytes()
        log(f"PWICP_PROFILE_DIR: one trace of register_pair, {kb:.0f} KiB, "
            f"the port's kernels in it: {has_kernel}")
        require(has_kernel, "PWICP_PROFILE_DIR: no kernel of the port in "
                "the trace")

    unified = pairwise.preprocess_segment_device
    calls = []
    pairwise.preprocess_segment_device = \
        lambda *a, **k: calls.append(1) or unified(*a, **k)
    os.environ["PWICP_NO_UNIFIED"] = "1"
    try:
        _cuda.reset_counts()
        t0 = time.perf_counter()
        res = pairwise.register_pair(c1, c2, pwt.PiecewiseICPConfig())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["PWICP_NO_UNIFIED"]
        pairwise.preprocess_segment_device = unified
    launches = dict(_cuda.LAUNCHES)
    require(not calls, "PWICP_NO_UNIFIED: the unified path ran")
    require(not _cuda.PLAIN_ON_CUDA, "PWICP_NO_UNIFIED: plain versions ran "
            f"on CUDA tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
    for name in PAIR_KERNELS:
        require(launches.get(name, 0) > 0,
                f"PWICP_NO_UNIFIED: kernel {name} was not launched")
    mean, mx = truth_mm(res.trans_mat, t_true, c2)
    log(f"PWICP_NO_UNIFIED: the smoke pair through the staged path "
        f"({len(c1)} points): residual vs truth mean {mean:.4f} mm, max "
        f"{mx:.4f} mm (bounds 2 mm / 5 mm); {wall:.3f} s; patches "
        f"{res.core.num_patches}; launches {launches}")
    require(mean < 2.0 and mx < 5.0,
            "PWICP_NO_UNIFIED: outside the truth bounds")


def capi_phase(seed: int) -> None:
    """``PiecewiseICP_pair_call`` of the port's C ABI through ctypes, with
    ``PWICP_TORCH_DEVICE`` unset (the card): returns true, writes the
    report, launches the pair path's kernels."""
    import ctypes
    import sysconfig

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch import native
    from piecewise_icp_torch.io import formats, write_pcd
    from piecewise_icp_torch.ops import _cuda

    header = pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"
    log(f"C ABI: g++ {shutil.which('g++')}, {header} exists: "
        f"{header.exists()}")
    t0 = time.perf_counter()
    path = native.build_capi()
    log(f"C ABI: {pathlib.Path(path).name} built in "
        f"{time.perf_counter() - t0:.2f} s")
    lib = ctypes.cdll.LoadLibrary(path)
    lib.PiecewiseICP_pair_call.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PiecewiseICP_pair_call.restype = ctypes.c_bool
    c1, c2, t_true = smoke_pair(seed)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_pcd(tmp / "Epoch_000.pcd", c1)
        write_pcd(tmp / "Epoch_001.pcd", c2)
        cfg = pwt.PiecewiseICPConfig(path1=str(tmp / "Epoch_000.pcd"),
                                     path2=str(tmp / "Epoch_001.pcd"))
        conf = tmp / "config_pair.txt"
        cfg.to_reference_file(conf)
        out = str(tmp) + os.sep
        os.environ.pop("PWICP_TORCH_DEVICE", None)
        _cuda.reset_counts()
        ok = lib.PiecewiseICP_pair_call(str(conf).encode(), out.encode())
        launches = dict(_cuda.LAUNCHES)
        require(ok is True, "C ABI: PiecewiseICP_pair_call returned false")
        require((tmp / "TransMatrix.txt").exists(),
                "C ABI: TransMatrix.txt missing")
        rep = formats.read_trans_matrix_report(tmp / "TransMatrix.txt")
    require(not _cuda.PLAIN_ON_CUDA, "C ABI: plain versions ran on CUDA "
            f"tensors: {dict(_cuda.PLAIN_ON_CUDA)}")
    for name in PAIR_KERNELS:
        require(launches.get(name, 0) > 0,
                f"C ABI: kernel {name} was not launched")
    mean, mx = truth_mm(rep["trans_mat"], t_true, c2)
    log(f"C ABI: PiecewiseICP_pair_call -> true, TransMatrix.txt written; "
        f"residual vs truth mean {mean:.4f} mm, max {mx:.4f} mm; launches "
        f"{launches}")
    require(mean < 2.0 and mx < 5.0, "C ABI: outside the truth bounds")


# the sharded phase's misaligned pair: a wider terrain pair (409,600 points
# an epoch at the smoke pair's spacing) whose source is raised 3 cm, under
# DTinit but beyond the stage-1 grid's h (0.02 m): on each of up to four
# shards more stable queries are unresolved than the rescue budget covers,
# and the rescued ones leave the percentile's index outside the resolved
# block, so the per-shard K5 rescue and the exact percentile through the
# gather both run
MIS_N_SIDE, MIS_EXTENT = 640, 3.2
MISALIGN_M = 0.03
SHARD_EPOCHS = 3
# the JAX package's mesh tolerances (tests/test_parallel.py:122-138)
SHARD_MGON, SHARD_MM, SHARD_VCM_RTOL = 0.5, 0.05, 5e-2
FOREIGN = ("jax", "jaxlib", "piecewise_icp_tpu")


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _counting_writes() -> dict:
    """Count, in this process, each call of the writers of the report, the
    tables and the pair files (a rank's count of its writes)."""
    from piecewise_icp_torch.io import formats

    calls: dict = {}
    for mod, names in ((formats, ("write_trans_matrix_report",
                                  "write_trans_matrices", "write_abs_errors",
                                  "write_reg_pairs")), (np, ("savez",))):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
    return calls


def _pair_report(res, timer_records) -> dict:
    return dict(trans_mat=res.trans_mat, vcm=res.vcm,
                iterations=res.core.iterations, dt=res.core.dt_series,
                exact=sum(r["phase"] == "core.percentile_exact"
                          for r in timer_records),
                rescued=[r["queries"] for r in timer_records
                         if r["phase"] == "core.stage1_rescue"])


def _profiled(run) -> dict:
    """``run()`` once under torch.profiler: its wall, the device's busy
    time (kernel and copy rows), the NCCL kernels' time and launches, and
    each of the port's kernels (time, launches) by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and e.device_type != DeviceType.CPU]
    nccl = [e for e in rows if "nccl" in e.key.lower()]
    return dict(wall_ms=wall * 1e3,
                busy_ms=sum(e.self_device_time_total for e in rows) / 1e3,
                nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3,
                nccl_launches=sum(e.count for e in nccl),
                kernels={port_kernel(e.key): (e.self_device_time_total
                                              / 1e3, e.count)
                         for e in rows if port_kernel(e.key)})


def _sharded_rank(group, t_launch, c1, c2, mis, conf_4d, conf_pair,
                  pair_prefix, reps):
    """One rank of a sharded launch: the smoke pair (cold, counted; then
    ``reps`` warm, each started after a barrier and timed to a
    synchronize of this rank's card, with the collectives it made), the
    misaligned pair (then ``reps`` warm), one of each profiled, the demo's
    staged loop on the raw smoke pair, the pair call from PCD files, and
    the campaign; every rank's report comes back through rank 0."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.parallel.demo import register_on_ranks
    from piecewise_icp_torch.parallel.distributed import context_devices
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    started_s = time.time() - t_launch
    cfg = pwt.PiecewiseICPConfig()
    dev = group.device

    def pair(cloud1, cloud2):
        GLOBAL_TIMER.records.clear()
        res = register_pair(cloud1, cloud2, cfg, device=dev, group=group)
        torch.cuda.synchronize()
        return _pair_report(res, GLOBAL_TIMER.records)

    def warm(cloud1, cloud2, first):
        times, differ = [], 0
        for _ in range(reps):
            group.barrier()
            calls, sent = collections.Counter(group.calls), \
                collections.Counter(group.bytes)
            t0 = time.perf_counter()
            again = pair(cloud1, cloud2)
            times.append(time.perf_counter() - t0)
            differ += bit_diff(again["trans_mat"], first["trans_mat"]) \
                + bit_diff(again["vcm"], first["vcm"])
        return times, differ, dict(
            calls=dict(collections.Counter(group.calls) - calls),
            bytes=dict(collections.Counter(group.bytes) - sent))

    _cuda.reset_counts()
    first = pair(c1, c2)
    out = dict(rank=group.rank, device=str(dev), started_s=started_s,
               launches=dict(_cuda.LAUNCHES),
               plain_on_cuda=dict(_cuda.PLAIN_ON_CUDA), pair=first)
    out["warm"], out["warm_bits_differ"], out["pair_collectives"] = \
        warm(c1, c2, first)
    out["mis"] = pair(*mis)
    out["warm_mis"], differ, _ = warm(*mis, out["mis"])
    out["warm_bits_differ"] += differ
    group.barrier()
    out["profile"] = _profiled(lambda: pair(c1, c2))
    group.barrier()
    out["profile_mis"] = _profiled(lambda: pair(*mis))
    out["core"] = register_on_ranks(group, c1, c2, cfg, t_launch)
    out["pair_call"] = pwt.piecewise_icp_pair_call(
        conf_pair, pair_prefix, device=dev, group=group)
    writes = _counting_writes()
    out["campaign_ok"] = pwt.piecewise_icp_4d_call(
        conf_4d, 0, SHARD_EPOCHS, -1, device=dev, group=group,
        kalman_enabled=True)
    out.update(writes=writes, contexts=context_devices(),
               foreign=_foreign_modules())
    return group.gather_object(out)


def _repeat_rank(group, t_launch, c1, c2):
    """One rank of a second launch: the smoke pair once."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.parallel.distributed import context_devices

    started_s = time.time() - t_launch
    res = register_pair(c1, c2, pwt.PiecewiseICPConfig(), device=group.device,
                        group=group)
    torch.cuda.synchronize()
    return group.gather_object(dict(started_s=started_s, device=str(
        group.device), trans_mat=res.trans_mat, vcm=res.vcm,
        contexts=context_devices(), foreign=_foreign_modules()))


def _within(label: str, got: dict, want: dict,
            same_iterations: bool = True) -> None:
    """The mesh tolerances: the same outer iterations (where asked), the
    transform within 0.5 mgon and 0.05 mm, the VCM within rtol 5e-2."""
    from piecewise_icp_torch.ops.transform import matrix_to_angles

    d_mgon = np.abs(np.array(matrix_to_angles(got["trans_mat"]))
                    - np.array(matrix_to_angles(want["trans_mat"]))).max() \
        * 1000.0 * 200.0 / np.pi
    d_mm = 1e3 * np.abs(got["trans_mat"][:3, 3]
                        - want["trans_mat"][:3, 3]).max()
    vcm_rel = float(np.max(np.abs(got["vcm"] - want["vcm"])
                           / np.maximum(np.abs(want["vcm"]), 1e-300)))
    log(f"sharded, {label}: outer iterations {got['iterations']} (single "
        f"device {want['iterations']}); against the single device "
        f"{d_mgon:.6f} mgon, {d_mm:.7f} mm, VCM relative {vcm_rel:.3g} "
        f"(bounds {SHARD_MGON} mgon, {SHARD_MM} mm, {SHARD_VCM_RTOL})")
    require(got["iterations"] == want["iterations"] or not same_iterations,
            f"sharded, {label}: other outer iterations than one device")
    require(d_mgon < SHARD_MGON and d_mm < SHARD_MM,
            f"sharded, {label}: transform outside the mesh tolerance")
    np.testing.assert_allclose(got["vcm"], want["vcm"], rtol=SHARD_VCM_RTOL,
                               atol=1e-14)


class AppsSampler:
    """``nvidia-smi --query-compute-apps=pid,gpu_bus_id,used_memory`` and
    each card's ``memory.used`` about every 0.5 s while the ``with`` block
    runs (the processes that hold a context, and where), and the cards on
    which this process holds a CUDA context, read from the driver
    (``context_devices``) before the block and at every sample."""

    def __enter__(self):
        from piecewise_icp_torch.parallel.distributed import context_devices

        self.context_devices = context_devices
        self.own_before = context_devices()
        self.own = set(self.own_before)
        self.apps, self.mem, self.done = [], {}, threading.Event()
        self.thread = threading.Thread(target=self._poll, daemon=True)
        self.thread.start()
        return self

    def _poll(self) -> None:
        while not self.done.wait(0.5):
            self.own.update(self.context_devices())
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,gpu_bus_id,"
                 "used_memory", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout
            self.apps.append([r.strip() for r in apps.splitlines()
                              if r.strip()])
            for row in smi_query("index,memory.used").splitlines():
                i, mem = (v.strip() for v in row.split(","))
                self.mem[i] = max(self.mem.get(i, "0 MiB"), mem,
                                  key=lambda m: float(m.split()[0]))

    def __exit__(self, *exc) -> None:
        self.done.set()
        self.thread.join(timeout=120)

    def summary(self) -> str:
        most = max(self.apps, key=len, default=[])
        return (f"{len(self.apps)} samples; at most {len(most)} processes "
                f"held a context at once ({most}); memory.used peak by card "
                f"{self.mem}; this process's CUDA contexts on cards "
                f"{self.own_before} before, {sorted(self.own)} while the "
                f"block ran; NCCL_NVLS_ENABLE "
                f"{os.environ.get('NCCL_NVLS_ENABLE', 'unset')}")


def port_kernel(key: str) -> "str | None":
    """The short name of one of the port's kernels from a profiler row's
    key (``pwicp::name``, or ``void pwicp::name<L>(...)`` for a template),
    else None."""
    name = key.split("(")[0].removeprefix("void ")
    return name if name.startswith("pwicp::") else None


def _secs(xs) -> str:
    return ", ".join(f"{x:.3f}" for x in xs)


def _warm_median(reports, key: str):
    """The time of each warm repeat over the ranks (the slowest rank's:
    each ends in a synchronize of its own card), and their median."""
    per_rep = [max(r[key][i] for r in reports)
               for i in range(len(reports[0][key]))]
    return statistics.median(per_rep), per_rep


def _sharded_run(nproc: int, backend: str, ctx: dict) -> dict:
    """Two launches of ``nproc`` ranks (``_sharded_rank``, then
    ``_repeat_rank``) and every check of the sharded phase on them."""
    from piecewise_icp_torch.io import formats
    from piecewise_icp_torch.parallel import launch

    label = (f"{nproc} {backend} ranks sharing one card (not a scaling "
             f"number)" if backend == "gloo" else f"{nproc} nccl ranks")
    tag = f"sharded, {nproc} {backend} ranks"
    c1, c2, mis, tmp = ctx["c1"], ctx["c2"], ctx["mis"], ctx["tmp"]
    out_dir = tmp / f"ranks{nproc}"
    conf = str(tmp / f"ranks{nproc}.txt")
    _campaign_config(ctx["scans"], out_dir).to_reference_file(conf)
    t_launch = time.time()
    t0 = time.perf_counter()
    with AppsSampler() as apps:
        reports = launch(_sharded_rank, nproc, t_launch, c1, c2, mis, conf,
                         ctx["conf_pair"], str(tmp / f"pair{nproc}_"), 3,
                         device="cuda", backend=backend, timeout=900)
    launch_a_s = time.perf_counter() - t0
    log(f"{tag}: nvidia-smi while the ranks ran: {apps.summary()}")
    errors = formats.read_abs_errors(out_dir / "TransPara_AbsError.txt")
    written = sorted(p.name for p in out_dir.iterdir())
    t_launch = time.time()
    t0 = time.perf_counter()
    again = launch(_repeat_rank, nproc, t_launch, c1, c2, device="cuda",
                   backend=backend, timeout=600)
    launch_b_s = time.perf_counter() - t0

    root, single, single_mis = reports[0], ctx["single"], ctx["single_mis"]
    for r in reports + again:
        require(not r["foreign"], f"{tag}: a rank imported {r['foreign']}")
        own = [int(r["device"].split(":")[1])]
        require(r["contexts"] == own, f"{tag}: a rank on {r['device']} holds "
                f"CUDA contexts on cards {r['contexts']}")
    for r in reports:
        require(not r["plain_on_cuda"], f"{tag}: rank {r['rank']} ran plain "
                f"versions on CUDA tensors: {r['plain_on_cuda']}")
        for name in PAIR_KERNELS:
            require(r["launches"].get(name, 0) > 0, f"{tag}: kernel {name} "
                    f"was not launched in rank {r['rank']}")
        log(f"{tag}: rank {r['rank']} on {r['device']} (CUDA contexts on "
            f"cards {r['contexts']} only): launches of the cold pair "
            f"{r['launches']}; plain versions on CUDA: none; no module of "
            f"jax, jaxlib or piecewise_icp_tpu loaded")
    bits = [bit_diff(r["pair"]["trans_mat"], root["pair"]["trans_mat"])
            for r in reports] + [
        bit_diff(r[k], root["pair"][k]) for k in ("trans_mat", "vcm")
        for r in again]
    core_bits = [bit_diff(np.asarray(r["trans_mat"]),
                          root["core"]["trans_mat"])
                 for r in root["core"]["ranks"]]
    log(f"{tag}: elements whose bits differ from rank 0's first transform: "
        f"{bits[:nproc]} (ranks, first launch), {bits[nproc:2 * nproc]} "
        f"(ranks, second launch; the VCM {bits[2 * nproc:]}); the warm "
        f"repeats of every rank differ in "
        f"{[r['warm_bits_differ'] for r in reports]}; the staged loop on the "
        f"raw pair: {core_bits}")
    require(not any(bits) and not any(core_bits)
            and not any(r["warm_bits_differ"] for r in reports),
            f"{tag}: the ranks or two launches gave other bits")
    _within(f"{nproc} ranks, smoke pair", root["pair"], single)
    _within(f"{nproc} ranks, staged loop on the raw smoke pair",
            root["core"], ctx["single_core"])
    mean, mx = truth_mm(root["pair"]["trans_mat"], ctx["t_true"], c2)
    log(f"{tag}, smoke pair: residual vs truth mean {mean:.4f} mm, max "
        f"{mx:.4f} mm (bounds 2 mm / 5 mm)")
    require(mean < 2.0 and mx < 5.0, f"{tag}: outside the truth bounds")

    rescued = {r["rank"]: r["mis"]["rescued"] for r in reports}
    log(f"{tag}, misaligned pair ({len(mis[0])} points an epoch, source "
        f"raised {MISALIGN_M} m): queries rescued by K5 a stage-1 call, by "
        f"rank {rescued} (budget {N_RESCUE} a shard); exact-percentile "
        f"fallbacks (through the gather) {root['mis']['exact']}, on one "
        f"device {single_mis['exact']} (rescues {single_mis['rescued']})")
    require(any(N_RESCUE in q for q in rescued.values()),
            f"{tag}: no shard had more unresolved queries than the budget")
    require(root["mis"]["exact"] > 0,
            f"{tag}: the exact percentile did not run through the gather")
    # the first DT is the exact percentile's; past the first iteration,
    # which removes the offset, the stage-2 decay may divide box changes
    # at float32 noise, so the iterations are reported, not held
    log(f"{tag}, misaligned pair: DT series {root['mis']['dt'][:3]}, on "
        f"one device {single_mis['dt'][:3]}")
    np.testing.assert_allclose(root["mis"]["dt"][:2], single_mis["dt"][:2],
                               rtol=1e-5)
    _within(f"{nproc} ranks, misaligned pair", root["mis"], single_mis,
            same_iterations=False)
    mean, mx = truth_mm(root["mis"]["trans_mat"], ctx["t_mis"], mis[1])
    log(f"{tag}, misaligned pair: residual vs truth mean {mean:.4f} mm, "
        f"max {mx:.4f} mm")
    require(mean < 2.0 and mx < 5.0,
            f"{tag}: misaligned pair outside the truth bounds")

    require(root["pair_call"], f"{tag}: the pair call returned False")
    require(all(r["campaign_ok"] for r in reports),
            f"{tag}: the campaign returned False on a rank")
    writes = [r["writes"] for r in reports]
    want = dict(write_trans_matrix_report=SHARD_EPOCHS - 1,
                write_trans_matrices=3, write_abs_errors=2,
                write_reg_pairs=1, savez=SHARD_EPOCHS - 1)
    log(f"{tag}, {SHARD_EPOCHS}-epoch campaign: writes by rank {writes}; "
        f"files {written}")
    require(writes[0] == want and not any(writes[1:]),
            f"{tag}: the campaign's files were not each written once by "
            f"rank 0 ({want})")
    d_e = np.abs(errors - ctx["errors_one"])
    log(f"{tag}, campaign: chained errors against the one-device campaign:"
        f" {d_e[:, :3].max():.6f} mgon, {d_e[:, 3:].max():.7f} mm (bounds "
        f"{SHARD_MGON} / {SHARD_MM}); max error {errors[:, :3].max():.4f} "
        f"mgon, {errors[:, 3:].max():.5f} mm")
    require(d_e[:, :3].max() < SHARD_MGON and d_e[:, 3:].max() < SHARD_MM,
            f"{tag}: campaign outside the mesh tolerance")

    coll = root["pair_collectives"]
    log(f"{tag}: collectives of one warm pair on rank 0: calls "
        f"{coll['calls']}; bytes of their results {coll['bytes']} "
        f"({sum(coll['bytes'].values())} in all); outer iterations "
        f"{root['pair']['iterations']}")
    smi = ctx["smi"]
    for key, what in (("warm", "smoke pair"), ("warm_mis", "misaligned "
                                               "pair")):
        med, per_rep = _warm_median(reports, key)
        log(f"{tag}: warm {what}, median of 3 (the slowest rank's time a "
            f"repeat): one device {statistics.median(ctx[key]):.3f} s "
            f"({_secs(ctx[key])}); {label} {med:.3f} s ({_secs(per_rep)}); "
            f"{smi}")
    for key, what in (("profile", "smoke pair"), ("profile_mis",
                                                  "misaligned pair")):
        for r in reports:
            p = r[key]
            rest = p["busy_ms"] - p["nccl_ms"]
            log(f"{tag}: profiled warm {what}, rank {r['rank']}: "
                f"{p['wall_ms']:.1f} ms wall, device busy {p['busy_ms']:.1f} "
                f"ms ({100 * p['busy_ms'] / p['wall_ms']:.1f}%), NCCL kernels "
                f"{p['nccl_ms']:.3f} ms in {p['nccl_launches']} launches (a "
                f"collective's kernel runs until every rank has joined it); "
                f"the rest {rest:.1f} ms ({100 * rest / p['wall_ms']:.1f}%)")
        one = ctx[key]
        log(f"{tag}: profiled warm {what}, one device: {one['wall_ms']:.1f} "
            f"ms wall, device busy {one['busy_ms']:.1f} ms "
            f"({100 * one['busy_ms'] / one['wall_ms']:.1f}%)")
        for name, (ms, n) in sorted(reports[0][key]["kernels"].items()):
            ms1, n1 = one["kernels"].get(name, (0.0, 0))
            log(f"{tag}: {what}, {name}: rank 0 {1e3 * ms / n:.1f} us a "
                f"launch x{n}; one device "
                + (f"{1e3 * ms1 / n1:.1f} us a launch x{n1}" if n1 else
                   "not launched"))
    starts = [r["started_s"] for r in reports + again]
    log(f"{tag}: rank start-up (launch to the rank's first line: spawn, "
        f"imports, process group) {_secs(starts)} s; launches "
        f"{launch_a_s:.2f} s (pairs, profiles and campaign) and "
        f"{launch_b_s:.2f} s (one pair); {smi}")
    tables = {p.name: p.read_bytes() for p in out_dir.glob("*.txt")}
    return dict(core=root["core"], tables=tables,
                pair_report=pathlib.Path(
                    str(tmp / f"pair{nproc}_") + "TransMatrix.txt"
                ).read_bytes())


def _campaign_config(scans, out_dir):
    """The sharded phase's campaign configuration (auto DT-init)."""
    import piecewise_icp_torch as pwt

    return pwt.PiecewiseICPConfig(path1=str(scans), path2=str(out_dir) + "/",
                                  set_dtinit=False)


def sharded_phase(seed: int) -> None:
    """The staged loop point-sharded over a process group (``parallel``).
    Where two cards or more are visible: NCCL, one card a rank, at 2 and
    at min(count, 4) ranks; else gloo with 2 ranks on ``cuda:0``.  At each
    rank count: the smoke pair against one device in this process (mesh
    tolerances, truth bounds, every rank's transform and a second launch
    bit-equal, K1-K4 launched in every rank, no plain version on a CUDA
    tensor, no JAX module, each rank's CUDA contexts on its own card
    alone); a misaligned pair (the per-shard rescue and the exact
    percentile through the gather); a 3-epoch campaign (every table
    written once, chained errors against one device); warm times, the
    collectives of a pair (calls, bytes, NCCL kernel time), each rank's
    busy share and kernels, the ranks' start-up.  Then the multi-controller
    demo (``parallel.demo``: 2 host launchers over ``tcp://127.0.0.1``, of
    min(count, 4) // 2 NCCL ranks each, or 1 gloo rank each on one card):
    bit-equal to the single-host launch of as many ranks.  Where four
    cards are visible, the ``pair`` and ``4d`` CLIs with ``--mesh-devices
    4`` write the bytes of the in-process launch."""
    import torch
    import torch.distributed as dist

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.io import formats, write_pcd
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.models.piecewise_icp import piecewise_icp
    from piecewise_icp_torch.ops.transform import translation_matrix
    from piecewise_icp_torch.parallel import demo
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER
    from piecewise_icp_torch.utils.synth import make_pair, make_series, \
        write_ground_truth

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    count = torch.cuda.device_count()
    if count >= 2:
        backend, plan = "nccl", sorted({2, min(count, 4)})
        hosts, per_host = 2, min(count, 4) // 2
        where = "one card a rank"
    else:
        backend, plan, hosts, per_host = "gloo", [2], 2, 1
        where = ("both on cuda:0; NCCL not run: torch.cuda.device_count() "
                 "is 1, and NCCL takes one card a rank")
    log(f"sharded: torch.cuda.device_count() {count}; backend {backend} "
        f"(NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
        f"available {dist.is_nccl_available()}), ranks {plan} ({where}); "
        f"demo {hosts} hosts x {per_host}")

    c1, c2, t_true = smoke_pair(seed)
    m1, m2, t_mis = make_pair(np.random.default_rng(seed + 5), PARAMS,
                              n_side=MIS_N_SIDE, extent=MIS_EXTENT)
    mis = (m1, m2 + np.float32([0.0, 0.0, MISALIGN_M]))
    t_mis = translation_matrix(np.array([0.0, 0.0, MISALIGN_M])) @ t_mis
    cfg = pwt.PiecewiseICPConfig()

    def one_device(cloud1, cloud2):
        GLOBAL_TIMER.records.clear()
        res = register_pair(cloud1, cloud2, cfg)
        torch.cuda.synchronize()
        return _pair_report(res, GLOBAL_TIMER.records)

    def warm(cloud1, cloud2):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            one_device(cloud1, cloud2)
            times.append(time.perf_counter() - t0)
        return times

    ctx = dict(c1=c1, c2=c2, t_true=t_true, mis=mis, t_mis=t_mis, smi=smi)
    ctx["single"] = one_device(c1, c2)
    ctx["warm"] = warm(c1, c2)
    ctx["single_mis"] = one_device(*mis)
    ctx["warm_mis"] = warm(*mis)
    ctx["profile"] = _profiled(lambda: one_device(c1, c2))
    ctx["profile_mis"] = _profiled(lambda: one_device(*mis))
    res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg)
    ctx["single_core"] = dict(trans_mat=res.trans_mat, vcm=res.vcm,
                              iterations=res.iterations)

    epochs, gt = make_series(np.random.default_rng(seed + 2), SHARD_EPOCHS,
                             trend=TREND_4D, n_side=N_SIDE, extent=EXTENT)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ctx["tmp"] = tmp
        scans = ctx["scans"] = tmp / "scans"
        scans.mkdir()
        for k, e in enumerate(epochs):
            write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
        write_ground_truth(tmp / "defined_transformations.txt", gt)
        write_pcd(tmp / "pair_1.pcd", c1)
        write_pcd(tmp / "pair_2.pcd", c2)
        ctx["conf_pair"] = str(tmp / "pair.txt")
        pwt.PiecewiseICPConfig(path1=str(tmp / "pair_1.pcd"),
                               path2=str(tmp / "pair_2.pcd")
                               ).to_reference_file(ctx["conf_pair"])
        _campaign_config(scans, tmp / "one").to_reference_file(
            tmp / "one.txt")
        require(pwt.piecewise_icp_4d_call(str(tmp / "one.txt"), 0,
                                          SHARD_EPOCHS, -1,
                                          kalman_enabled=True),
                "sharded: the one-device campaign returned False")
        ctx["errors_one"] = formats.read_abs_errors(
            tmp / "one" / "TransPara_AbsError.txt")
        runs = {n: _sharded_run(n, backend, ctx) for n in plan}

        world = hosts * per_host
        report = demo.run(c1, c2, t_true, cfg, hosts=hosts, nproc=per_host,
                          device="cuda", backend=backend, timeout=600)
        w0 = report["workers"][0]
        tag = f"sharded, demo of {hosts} hosts x {per_host} {backend} ranks"
        for w in report["workers"]:
            log(f"{tag}: host {w['process_id']}: ranks "
                + "; ".join(f"{r['rank']} on {r['device']} (contexts on "
                            f"{r['contexts']}, started at {r['started_s']:.3f}"
                            f" s)" for r in w["ranks"] if
                            r["rank"] // per_host == w["process_id"])
                + f"; pair {w['seconds']:.3f} s (cold), {w['iterations']} "
                f"iterations, residual mean {w['mean_residual_mm']:.4f} mm, "
                f"max {w['max_residual_mm']:.4f} mm")
        demo_bits = [bit_diff(np.asarray(w["trans_mat"]),
                              runs[world]["core"]["trans_mat"])
                     for w in report["workers"]]
        log(f"{tag}: over {report['address']}, ok {report['ok']}, "
            f"cross-host transform difference "
            f"{report['cross_process_param_diff']}; elements whose bits "
            f"differ from the single-host launch of {world} ranks "
            f"{demo_bits}; wall {report['wall_s']:.2f} s; {smi}")
        require(report["ok"], f"{tag}: the report is not ok")
        require(not any(demo_bits), f"{tag}: other bits than one host of "
                f"{world} ranks")
        _within(f"demo of {hosts} x {per_host}",
                dict(trans_mat=np.asarray(w0["trans_mat"]),
                     vcm=np.asarray(w0["vcm"]),
                     iterations=w0["iterations"]), ctx["single_core"])

        if count >= 4:
            cli_phase(tmp, runs[4], scans)
        else:
            log("sharded: the CLIs with --mesh-devices 4 not run: "
                f"{count} card(s) visible")
    log(f"sharded: phase {time.perf_counter() - t_phase:.1f} s; {smi}")


def cli_phase(tmp: pathlib.Path, run4: dict, scans: pathlib.Path) -> None:
    """``python -m piecewise_icp_torch pair ... --mesh-devices 4`` and
    ``4d ... --mesh-devices 4``, both at once: their report and tables
    must be the bytes of the in-process launch of 4 ranks."""
    _campaign_config(scans, tmp / "cli").to_reference_file(tmp / "cli.txt")
    cmds = {"pair": ["pair", "--config", str(tmp / "pair.txt"), "--out",
                     str(tmp / "cli_pair_")],
            "4d": ["4d", "--config", str(tmp / "cli.txt"), "--epochs",
                   str(SHARD_EPOCHS), "--mode", "-1", "--kalman"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "piecewise_icp_torch", *v, "--mesh-devices",
         "4"], cwd=pathlib.Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, v in cmds.items()}
    outs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    wall = time.perf_counter() - t0
    for k, p in procs.items():
        require(p.returncode == 0, f"sharded, CLI {k} --mesh-devices 4 "
                f"exited {p.returncode}:\n{outs[k][-3000:]}")
    same_pair = (tmp / "cli_pair_TransMatrix.txt").read_bytes() \
        == run4["pair_report"]
    tables = {p.name: p.read_bytes() for p in (tmp / "cli").glob("*.txt")}
    differ = sorted(n for n in set(tables) | set(run4["tables"])
                    if tables.get(n) != run4["tables"].get(n))
    log(f"sharded, CLIs with --mesh-devices 4 (both at once, {wall:.1f} s): "
        f"pair report byte-equal to the in-process launch's {same_pair}; "
        f"4d: {len(tables)} tables, those that differ {differ}")
    require(same_pair and not differ and len(tables) >= 9,
            "sharded: the CLIs wrote other bytes than the in-process launch")


def four_d_phase(seed: int, k5_ms: float) -> dict:
    """The 4D campaign through the user entry point: 20 epochs of 142,884
    points, adaptive planning, auto DT-init, Kalman smoothing."""
    import torch

    import piecewise_icp_torch as pwt
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.transform import matrix_to_params_gon
    from piecewise_icp_torch.utils.synth import make_series, \
        write_ground_truth
    from piecewise_icp_torch.io import formats, write_pcd
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    t0 = time.perf_counter()
    epochs, gt = make_series(np.random.default_rng(seed + 2), N_EPOCHS,
                             trend=TREND_4D, n_side=N_SIDE, extent=EXTENT)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        scans = tmp / "scans"
        scans.mkdir()
        for k, e in enumerate(epochs):
            write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
        write_ground_truth(tmp / "defined_transformations.txt", gt)
        out = tmp / "out"
        cfg = pwt.PiecewiseICPConfig(path1=str(scans),
                                     path2=str(out) + "/", set_dtinit=False)
        conf = tmp / "config_4d.txt"
        cfg.to_reference_file(conf)
        log(f"4d: {N_EPOCHS} epochs of {len(epochs[0])} points written in "
            f"{time.perf_counter() - t0:.2f} s (trend {TREND_4D} m a step); "
            f"isSetDTinit 0, res/SV {cfg.res1}/{cfg.svsize1}, adaptive "
            f"mode, Kalman on")

        GLOBAL_TIMER.records.clear()
        _cuda.reset_counts()
        t0 = time.perf_counter()
        ok = pwt.piecewise_icp_4d_call(str(conf), 0, N_EPOCHS, -1,
                                       device="cuda", kalman_enabled=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        plain_on_cuda = dict(_cuda.PLAIN_ON_CUDA)
        host = GLOBAL_TIMER.summary()
        k5_calls = collections.Counter(
            r["phase"] for r in GLOBAL_TIMER.records
            if r["phase"] == K5_RESCUE_PHASE or r["phase"] in K5_OTHER_PHASES)
        most_rescued = max((r["queries"] for r in GLOBAL_TIMER.records
                            if r["phase"] == K5_RESCUE_PHASE), default=0)
        n_segmented = sum(r["phase"] == "seg.fused"
                          for r in GLOBAL_TIMER.records)
        k7_calls = {k: sum(r.get("counts", {}).get(k, 0)
                           for r in GLOBAL_TIMER.records)
                    for k in ("voxel_device", "seeds_device")}
        require(ok, "piecewise_icp_4d_call returned False")
        for name in OUTPUTS_4D:
            require((out / name).exists(), f"4d: {name} missing")
        for k in range(2, N_EPOCHS + 1):
            require((out / f"{k}_Adaptive_TransMatrix.txt").exists(),
                    f"4d: pair report of epoch {k} missing")
        errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
        raw = formats.read_trans_parameters(
            out / "TransParameters_toRef.txt")
        sm = formats.read_trans_parameters(
            out / "TransParameters_toRef_smoothed.txt")
        plan = formats.read_reg_pairs(out / "RegPairFile.txt")
        phases = [json.loads(ln) for ln in
                  (out / "phase_timings.jsonl").read_text().splitlines()]
        digest = {name: hashlib.sha256((out / name).read_bytes())
                  .hexdigest()[:16] for name in REPRO_TABLES}
        # the first five epochs again (4 pairs, warm): under the profiler,
        # then without it; the two must write the same bytes
        tables = []
        for label in ("profiled", "plain"):
            cfg.path2 = str(tmp / f"out_5_{label}") + "/"
            cfg.to_reference_file(conf)
            run = (lambda: pwt.piecewise_icp_4d_call(
                str(conf), 0, 5, -1, device="cuda", kalman_enabled=True))
            if label == "profiled":
                profile_run(run, "4d, 5 epochs")
            else:
                require(run(), "4d, 5 epochs: piecewise_icp_4d_call "
                        "returned False")
            tables.append({name: (tmp / f"out_5_{label}" / name).read_bytes()
                           for name in REPRO_TABLES})

    for name in CAMPAIGN_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched in the 4D campaign")
    require(launches.get("nn1_brute", 0) >= N_EPOCHS - 1,
            "auto DT-init did not launch K5 once per pair")
    # the stage-1 rescue runs through K5: every call of the K5 wrapper sits
    # in a timer phase of its own, so the launches are exactly the rescues
    # plus the other calls of this same run
    n_rescue = k5_calls[K5_RESCUE_PHASE]
    n_other = sum(k5_calls[p] for p in K5_OTHER_PHASES)
    require(n_rescue > 0, "4d: no iteration had unresolved "
            "stage-1 queries; the rescue was not driven")
    require(k5_calls["core.dtinit"] == N_EPOCHS - 1,
            f"4d: auto DT-init ran {k5_calls['core.dtinit']} times for "
            f"{N_EPOCHS - 1} pairs")
    require(launches["nn1_brute"] == n_other + n_rescue,
            f"4d: {n_rescue} stage-1 rescues and {n_other} other calls of "
            f"the brute 1-NN ({dict(k5_calls)}) but "
            f"{launches['nn1_brute']} K5 launches")
    # label propagation: the whole loop is one launch a cloud, read once
    require(n_segmented >= N_EPOCHS, f"4d: {n_segmented} clouds segmented "
            f"for {N_EPOCHS} epochs")
    require(launches["propagate"] == n_segmented,
            f"4d: {n_segmented} clouds segmented but "
            f"{launches['propagate']} whole-loop launches of K4")
    require(launches["seg_stats"] == n_segmented,
            f"4d: {n_segmented} clouds segmented but "
            f"{launches['seg_stats']} K3 launches")
    # the voxel grouping: a seed choice a segmented cloud, each call of K7
    # counted in its span, one launch of each entry a call
    n_k7 = k7_calls["voxel_device"] + k7_calls["seeds_device"]
    require(k7_calls["seeds_device"] == n_segmented,
            f"4d: {n_segmented} clouds segmented but "
            f"{k7_calls['seeds_device']} seed choices on the card")
    require(launches["voxel_keys"] == n_k7
            and launches["voxel_segments"] == n_k7,
            f"4d: {k7_calls} calls of K7 counted in spans but "
            f"{launches['voxel_keys']} / {launches['voxel_segments']} "
            f"launches of its two entries")
    log(f"4d: {n_segmented} clouds segmented: {launches['seg_stats']} K3 "
        f"launches, {launches['propagate']} whole-loop calls of K4 in "
        f"{launches['prop_round']} K4 launches "
        f"({launches['prop_round'] / n_segmented:.2f} a cloud, one host read "
        f"each); K7: {k7_calls['voxel_device']} downsamples and "
        f"{k7_calls['seeds_device']} seed choices on the card")
    require(not plain_on_cuda,
            f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    require(len(set(plan.values())) > 1,
            f"4d: the adaptive plan never advanced its target: {plan}")
    require(errors.shape == (N_EPOCHS - 1, 6) and np.isfinite(errors).all(),
            "4d: bad error table")
    log(f"4d: chained errors vs truth max {errors[:, :3].max():.3f} mgon, "
        f"{errors[:, 3:].max():.4f} mm; mean {errors[:, :3].mean():.3f} "
        f"mgon, {errors[:, 3:].mean():.4f} mm (bounds 200 mgon / 5 mm); "
        f"unrounded max {errors[:, :3].max()!r} mgon, "
        f"{errors[:, 3:].max()!r} mm; table digests {digest}")
    same = {name: tables[0][name] == tables[1][name] for name in REPRO_TABLES}
    log(f"4d, 5 epochs twice (profiled, then not): tables byte-equal {same}")
    require(all(same.values()), "4d, 5 epochs: two runs wrote different "
            f"tables: {same}")
    require(errors[:, :3].max() < 200.0 and errors[:, 3:].max() < 5.0,
            "4d: chained errors outside the bounds")
    gt_params = np.stack([matrix_to_params_gon(g) for g in gt[1:]])
    raw_err = np.abs(raw[:, 1:7] - gt_params).mean()
    sm_err = np.abs(sm[:, 1:7] - gt_params).mean()
    log(f"4d: mean parameter error raw {raw_err:.6g}, smoothed "
        f"{sm_err:.6g} (gon and m; bound raw x 1.25 + 1e-4)")
    require(sm_err <= raw_err * 1.25 + 1e-4, "4d: smoothing degraded")

    pair_s = [r["seconds"] for r in phases if r["phase"] == "pair"]
    plan_s = sum(r["seconds"] for r in phases
                 if r["phase"] == "pair_planning")
    other = ", ".join(f"{r['phase']} {r['seconds']:.3f}" for r in phases
                      if r["phase"] not in ("pair", "pair_planning"))
    log(f"4d: campaign {wall:.3f} s for {N_EPOCHS} epochs "
        f"({wall / N_EPOCHS:.3f} s/epoch, {wall / (N_EPOCHS - 1):.3f} "
        f"s/pair); planning {plan_s:.3f} s; plan {plan}")
    log(f"4d: pair phase (registration, epochs prepared) mean "
        f"{1e3 * statistics.mean(pair_s):.1f} ms, median "
        f"{1e3 * statistics.median(pair_s):.1f}, min {1e3 * min(pair_s):.1f}"
        f", max {1e3 * max(pair_s):.1f}; {other} (s)")
    log("4d: host phases (s, both threads, nested phases overlap): "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(host.items(), key=lambda kv: -kv[1])))
    log(f"4d: K5 at 142,884 x 142,884 takes {k5_ms:.3f} ms, "
        f"{100 * k5_ms / (1e3 * statistics.mean(pair_s)):.2f}% of the mean "
        f"pair phase; {n_rescue} stage-1 rescues (up to {most_rescued} "
        f"unresolved queries) and {n_other} other calls {dict(k5_calls)} "
        f"make the {launches['nn1_brute']} K5 launches; launches "
        f"{launches}; plain versions on CUDA: none")
    return launches


class SmiSampler:
    """``nvidia-smi``'s ``utilization.gpu`` and ``memory.used`` about every
    100 ms while the ``with`` block runs, each sample with the time
    ``nvidia-smi`` stamps on it (its output may reach the pipe late)."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi",
             "--query-gpu=timestamp,utilization.gpu,memory.used",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self) -> None:
        import datetime

        for line in self.proc.stdout:
            try:
                stamp, util, mem = (v.strip() for v in line.split(","))
                t = datetime.datetime.strptime(
                    stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((t, float(util), float(mem)))
            except ValueError:
                continue

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)

    def within(self, window) -> dict:
        """Mean utilization (%), peak memory used (MiB) and the number of
        samples between ``window``'s two times."""
        s = [x for x in self.samples if window[0] <= x[0] <= window[1]]
        return {"samples": len(s),
                "util_mean_pct": statistics.mean(x[1] for x in s)
                if s else None,
                "mem_peak_mib": max(x[2] for x in s) if s else None}


def smi_query(field: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def fleet_phase(seed: int) -> dict:
    """BASELINE configuration 5: the 101-epoch series of
    ``piecewise_icp_torch.utils.scale`` (the 142,884-point base of
    ``seed``) as fleets of 1, 2 and 4 concurrent worker processes sharing
    the card (``run_fleet``: ``4d --shards W --shard i --no-finalize``,
    then one ``--resume`` finalise), each into a fresh folder.  Every
    worker exits 0 and launches K1-K4 with no plain version on the card;
    100 pair files and every table exist; the tables of W = 2 and 4 equal
    W = 1's byte for byte; every pair within 2 mm mean and 5 mm max of its
    relative truth.  Prints each fleet's walls, epochs/s, speedup and
    efficiency, the card's utilization and memory while the workers run.
    Then the quasi-static Kalman campaign of the same base in this
    process (smoothing must not degrade the mean error).  Returns each
    kernel's launches in every worker of the three fleets."""
    import torch

    from piecewise_icp_torch.io import formats
    from piecewise_icp_torch.ops import _cuda
    from piecewise_icp_torch.ops.transform import matrix_to_params_gon
    from piecewise_icp_torch.utils import scale

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    mode = smi_query("compute_mode")
    cores = len(os.sched_getaffinity(0))
    log(f"fleet: compute mode {mode}; os.cpu_count() {os.cpu_count()}, "
        f"{cores} cores in this process's affinity; "
        f"{torch.cuda.device_count()} card(s): {card}")
    torch.cuda.empty_cache()
    base = scale.default_base(seed)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scans = scale.generate_series(tmp, FLEET_EPOCHS, base, seed=seed)
        gt = os.path.join(tmp, "defined_transformations.txt")
        log(f"fleet: series of {FLEET_EPOCHS} epochs of {len(base)} points "
            f"written in {time.perf_counter() - t0:.2f} s")
        for w in FLEET_WORKERS:
            out = os.path.join(tmp, f"out_{w}w")
            with SmiSampler() as smi:
                rec = scale.run_fleet(
                    scale.scale_config(scans, out), out, FLEET_EPOCHS, 1, w,
                    device="cuda", ground_truth=gt,
                    baseline_s=runs[1]["pairs_wall_s"] if w > 1 else None,
                    timeout=900)
            rec["smi"] = smi.within(rec["window"])
            rec["tables"] = {name: pathlib.Path(out, name).read_bytes()
                             for name in scale.FLEET_TABLES}
            if w == 1:
                residuals = scale.pair_residuals_mm(out, scans, gt,
                                                    FLEET_EPOCHS - 1)
                errors = formats.read_abs_errors(
                    os.path.join(out, "TransPara_AbsError.txt"))
                smoothed = formats.read_abs_errors(
                    os.path.join(out, "TransPara_AbsError_smoothed.txt"))
                digest = scale.table_digests(out)["TransMatrices_toRef.txt"]
            pairs = sorted(os.listdir(os.path.join(out, "pairs")))
            require(pairs == [f"pair_{k:04d}.npz"
                              for k in range(1, FLEET_EPOCHS)],
                    f"fleet of {w}: {len(pairs)} pair files")
            for name in OUTPUTS_4D:
                require(name == "RegPairFile.txt"
                        or os.path.exists(os.path.join(out, name)),
                        f"fleet of {w}: {name} missing")
            runs[w] = rec
            smi_s = rec["smi"]
            log(f"fleet of {w} ({card}): pairs wall "
                f"{rec['pairs_wall_s']:.3f} s, workers done at "
                f"{[round(t, 3) for t in rec['per_worker_done_s']]} s, "
                f"finalise {rec['finalize_wall_s']:.3f} s, "
                f"{rec['epochs_per_s']:.4f} epochs/s, speedup "
                f"{rec.get('speedup_vs_1', 1.0):.3f}, efficiency "
                f"{rec.get('efficiency_pct', 100.0):.1f}%, "
                f"{rec['threads_per_worker']} threads a worker on "
                f"{rec['cores']} cores ({rec['devices']}), the workers' "
                f"CPU {[round(t, 1) for t in rec['worker_cpu_s']]} s, "
                f"start-up to the worker's entry "
                f"{[round(t, 2) for t in rec['worker_startup_s']]} s, "
                f"{rec['host_busy_pct']:.1f}% of the cores; utilization.gpu "
                f"mean {smi_s['util_mean_pct']}%, memory.used peak "
                f"{smi_s['mem_peak_mib']} MiB ({smi_s['samples']} samples "
                f"while the workers ran); launches {rec['launches']}")

        for w, rec in runs.items():
            for i, (n, plain) in enumerate(zip(rec["launches"],
                                               rec["plain_on_cuda"])):
                for name in FLEET_KERNELS:
                    require(n.get(name, 0) > 0, f"fleet of {w}: worker {i} "
                            f"launched no {name}")
                require(not plain, f"fleet of {w}: worker {i} ran plain "
                        f"versions on the card: {plain}")
            same = {name: rec["tables"][name] == runs[1]["tables"][name]
                    for name in scale.FLEET_TABLES}
            require(all(same.values()), f"fleet of {w}: tables differ from "
                    f"one worker's: {same}")
        log(f"fleet: the tables of {FLEET_WORKERS[1:]} workers equal one "
            f"worker's byte for byte; TransMatrices_toRef.txt {digest}")
        log(f"fleet: pair residuals against the relative truth: mean of "
            f"means {residuals[:, 0].mean():.4f} mm, worst mean "
            f"{residuals[:, 0].max():.4f} mm, worst max "
            f"{residuals[:, 1].max():.4f} mm (bounds 2 / 5 mm); chained "
            f"errors mean {errors[:, :3].mean(0).round(3).tolist()} mgon, "
            f"{errors[:, 3:].mean(0).round(4).tolist()} mm, max "
            f"{float(errors[:, :3].max())!r} mgon, "
            f"{float(errors[:, 3:].max())!r} mm; smoothed mean "
            f"{smoothed[:, :3].mean(0).round(3).tolist()} mgon, "
            f"{smoothed[:, 3:].mean(0).round(4).tolist()} mm, max "
            f"{float(smoothed[:, :3].max())!r} mgon, "
            f"{float(smoothed[:, 3:].max())!r} mm")
        require(residuals[:, 0].max() < 2.0 and residuals[:, 1].max() < 5.0,
                "fleet: a pair is outside the truth bounds")

    # the quasi-static campaign, in this process
    with tempfile.TemporaryDirectory() as tmp:
        _cuda.reset_counts()
        t0 = time.perf_counter()
        rep = scale.run_quasistatic(tmp, QUASI_EPOCHS, base=base,
                                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        plain_on_cuda = dict(_cuda.PLAIN_ON_CUDA)
        out = pathlib.Path(tmp, "results")
        raw = formats.read_trans_parameters(
            out / "TransParameters_toRef.txt")
        sm = formats.read_trans_parameters(
            out / "TransParameters_toRef_smoothed.txt")
        _, gt_q = formats.read_ground_truth_transforms(
            pathlib.Path(tmp, "defined_transformations.txt"))
    gt_params = np.stack([matrix_to_params_gon(g) for g in gt_q[1:]])
    raw_err = np.abs(raw[:, 1:7] - gt_params).mean()
    sm_err = np.abs(sm[:, 1:7] - gt_params).mean()
    log(f"quasistatic ({card}): {QUASI_EPOCHS} epochs, direct mode, "
        f"Kalman, {wall:.3f} s; report {json.dumps(rep)}; independent-"
        f"component reduction {rep['independent_component_reduction']:.4f} "
        f"(the JAX package's on the reference scan, another base: "
        f"{JAX_QUASI_REDUCTION}); mean parameter error raw {raw_err:.6g}, "
        f"smoothed {sm_err:.6g} (gon and m; bound raw x 1.25 + 1e-4); "
        f"launches {launches}")
    require(rep["ok"], "quasistatic: run_4d returned False")
    require(sm_err <= raw_err * 1.25 + 1e-4, "quasistatic: smoothing "
            "degraded the mean error")
    for name in FLEET_KERNELS:
        require(launches.get(name, 0) > 0, f"quasistatic: no {name}")
    require(not plain_on_cuda,
            f"quasistatic: plain versions on the card: {plain_on_cuda}")
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f} s")
    return {name: [[n.get(name, 0) for n in runs[w]["launches"]]
                   for w in FLEET_WORKERS] for name in REPLACES}


def bench_phase(seed: int) -> None:
    """``bench_torch.py``'s measurement at the card's defaults, its line
    printed on a line of its own; fails on a key missing from the line, a
    pair outside the truth bounds, campaign errors outside 200 mgon / 5 mm,
    K1-K4 not launched in the warm pair or K1, K2, K5 in the kernel
    timings, a plain version on a CUDA tensor, or a share of a bound above
    100%."""
    import bench_torch

    t0 = time.perf_counter()
    rec = bench_torch.measure(seed)
    print(json.dumps(rec), flush=True)
    missing = bench_torch.missing_keys(rec)
    require(not missing, f"bench: the line lacks {missing}")
    log(f"bench: warm pair {rec['variance']['warm_s']} s (min, median, "
        f"max), campaign {rec['variance']['campaign_epoch_s']} s a pair, "
        f"serial {rec['variance']['campaign_serial_epoch_s']} s, cold "
        f"{rec['cold_s']:.3f} s, fresh process {rec['cold_fresh_s']} s; "
        f"residual {rec['residual_mean_mm']:.4f} / "
        f"{rec['residual_max_mm']:.4f} mm; campaign errors "
        f"{rec['campaign_errors']}; the phase {time.perf_counter() - t0:.1f} "
        f"s")
    require(rec["residual_mean_mm"] < 2.0 and rec["residual_max_mm"] < 5.0,
            "bench: the pair is outside the truth bounds (2 mm / 5 mm)")
    err = rec["campaign_errors"]
    require(err["rot_max_mgon"] < 200.0 and err["trans_max_mm"] < 5.0,
            f"bench: campaign errors {err} outside 200 mgon / 5 mm")
    for name in PAIR_KERNELS:
        require(rec["launches"].get(name, 0) > 0,
                f"bench: kernel {name} was not launched in the warm pair")
    require(not rec["plain_on_cuda"],
            f"bench: plain versions ran on CUDA tensors: "
            f"{rec['plain_on_cuda']}")
    nn = rec["nn_kernels"]
    for name in ("range_nn1", "knn_sorted", "nn1_brute"):
        require(nn["launches"][name] > 0,
                f"bench: kernel {name} was not launched in nn_kernels")
    for name, roof in nn["roofline"].items():
        if name != "model":
            require(roof["share_pct"] <= 100.0,
                    f"bench: {name} at {roof['share_pct']}% of its bound")


def profile_run(run, label: str) -> float:
    """``run`` once more under torch.profiler: wall time, host phases, the
    device's busy share and its kernels by time (where the time goes).
    Returns the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

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
    log(f"profile {label}: {wall * 1e3:.1f} ms; host phases (ms, nested "
        f"phases overlap): {phases}")
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    # a CPU operator's row repeats the time of the kernels it launched:
    # the busy time sums the device rows only
    kernels = [e for e in rows if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    all_rows = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"profile {label}: device busy {busy:.1f} ms of {wall * 1e3:.1f} ms "
        f"wall ({100 * busy / max(wall * 1e3, 1e-9):.1f}%; "
        f"{sum(e.count for e in kernels)} launches and copies under "
        f"{len(kernels)} kernel names; operator and kernel rows summed "
        f"together: {all_rows:.1f} ms)")
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the ten longest, and every kernel of the port (its time a launch on
    # this path, without the wrapper's host work)
    for e in by_time[:10] + [e for e in by_time[10:]
                             if port_kernel(e.key)]:
        log(f"profile {label}:   {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return busy / max(wall * 1e3, 1e-9)


def device_ms(fn, matches: tuple, reps: int = 10) -> dict:
    """Device time a call of the kernels whose names hold each of
    ``matches``, from torch.profiler over ``reps`` calls after one
    warm-up: {match: ms}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    return {m: sum(e.self_device_time_total for e in events if m in e.key)
            / 1e3 / reps for m in matches}


# K7's entries and the kernels each launches
VOXEL_KERNELS = {"voxel_keys": ("voxel_bounds", "voxel_keys"),
                 "voxel_segments": ("voxel_segments",)}


def voxel_phase(seed: int) -> dict:
    """K7 at the benchmark cells' shapes (one synthetic epoch of 418 x 418
    points, leaf 5 mm, seeds at 5 cm; the first rockfall epoch of the
    rockfall phase's series, leaf 0.3 m, seeds at 3 m): the downsample of
    the raw cloud and the seed choice over the segmentation grid
    (world-aligned origin), equal to ``voxel_downsample`` and
    ``propagate_seeds`` bit for bit, with one launch of each entry a call
    and no plain version on the card.  Times the wrapper, K7's own device
    time, its bound (the cloud read once, the voxels written once) and the
    plain versions (the host numpy functions).  Returns, for each cell,
    a row for each of K7's entries: its device time in the downsample
    (``ms``) and in the seed choice (``seeds_ms``), each against the bytes
    that entry reads and writes once, and the whole call's times."""
    import torch

    from piecewise_icp_torch.io import read_pcd
    from piecewise_icp_torch.models.segmentation_device import (
        _seg_h, propagate_seeds)
    from piecewise_icp_torch.ops import _cuda, voxel_cuda
    from piecewise_icp_torch.ops.grid_nn import build_grid
    from piecewise_icp_torch.ops.preprocess import voxel_downsample
    from piecewise_icp_torch.utils import rockfall
    from piecewise_icp_torch.utils.synth import terrain_cloud

    dev = torch.device("cuda")
    out = {}
    for cell, leaf, sv in (("synthetic", 0.005, 0.05),
                           ("rockfall", ROCKFALL_RES, 3.0)):
        _cuda.reset_counts()
        if cell == "synthetic":
            raw = terrain_cloud(np.random.default_rng(seed),
                                n_side=VOXEL_N_SIDE)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                scans = rockfall.generate_rockfall(
                    tmp, 1, seed=ROCKFALL_SEED, extent=ROCKFALL_EXTENT,
                    res=ROCKFALL_RES)
                raw = read_pcd(os.path.join(scans, os.listdir(scans)[0]))
        down = voxel_downsample(raw, leaf)
        grid_pts = build_grid(down, _seg_h(KNN_NORMALS, leaf)
                              ).points[:len(down)]
        origin = np.floor(grid_pts.astype(np.float64).min(axis=0) / sv) * sv
        seeds = propagate_seeds(grid_pts, sv, origin=origin)
        t_raw = torch.from_numpy(raw).to(dev)
        t_grid = torch.from_numpy(grid_pts).to(dev)
        got = voxel_cuda.voxel_centroids(t_raw, leaf).cpu().numpy()
        require(got.tobytes() == down.tobytes(),
                f"K7 {cell}: centroids differ from voxel_downsample")
        got_s = voxel_cuda.voxel_seeds(t_grid, sv, origin=origin)
        require(np.array_equal(got_s.cpu().numpy(), seeds),
                f"K7 {cell}: seeds differ from propagate_seeds")
        require(not _cuda.PLAIN_ON_CUDA
                and _cuda.LAUNCHES["voxel_keys"] == 2
                and _cuda.LAUNCHES["voxel_segments"] == 2,
                f"K7 {cell}: launches {dict(_cuda.LAUNCHES)}, plain "
                f"versions on CUDA tensors {dict(_cuda.PLAIN_ON_CUDA)}")
        n, m, ns = len(raw), len(down), len(seeds)

        def centroids():
            return voxel_cuda.voxel_centroids(t_raw, leaf)

        def seed_choice():
            return voxel_cuda.voxel_seeds(t_grid, sv, origin=origin)

        names = sum(VOXEL_KERNELS.values(), ())
        dev_c = device_ms(centroids, names)
        dev_s = device_ms(seed_choice, names)
        call = dict(
            points=n, voxels=m, seeds=ns,
            call_ms=time_ms(centroids, reps=20),
            call_bound_ms=bound(12 * n + 12 * m, 0)["bound_ms"],
            plain_ms=time_ms(lambda: voxel_downsample(raw, leaf),
                             device="cpu"),
            seeds_call_ms=time_ms(seed_choice, reps=20),
            seeds_call_bound_ms=bound(12 * m + 8 * ns, 0)["bound_ms"],
            seeds_plain_ms=time_ms(lambda: propagate_seeds(
                grid_pts, sv, origin=origin), device="cpu"))
        # the bytes each entry reads and writes once: the keys read the
        # points and write the keys (and the distances to the centres);
        # the walk reads the sorted keys, the permutation, the starts and
        # the points (or the distances) and writes the voxels
        io = {"voxel_keys": (12 * n + 8 * n, 12 * m + 16 * m),
              "voxel_segments": (8 * n + 8 * n + 8 * m + 12 * n + 12 * m,
                                 8 * m + 8 * m + 8 * ns + 8 * m + 8 * ns)}
        rows = out[cell] = {}
        for name, kernels in VOXEL_KERNELS.items():
            b_down, b_seed = io[name]
            seeds_bound = bound(b_seed, 0)
            rows[name] = dict(
                ms=sum(dev_c[k] for k in kernels),
                **bound(b_down, 0),
                seeds_ms=sum(dev_s[k] for k in kernels),
                seeds_bound_ms=seeds_bound["bound_ms"],
                seeds_bound_by=seeds_bound["bound_by"], **call)
        keys, walk = rows["voxel_keys"], rows["voxel_segments"]
        k7 = keys["ms"] + walk["ms"]
        k7_s = keys["seeds_ms"] + walk["seeds_ms"]
        log(f"K7 voxel, {cell}: {n} points -> {m} voxels, the same bits as "
            f"voxel_downsample; wrapper {call['call_ms']:.3f} ms, K7's "
            f"kernels {k7:.4f} ms (keys {keys['ms']:.4f}, walk "
            f"{walk['ms']:.4f}), bound {call['call_bound_ms']:.5f} ms "
            f"(bytes: {100 * call['call_bound_ms'] / call['call_ms']:.2f}% "
            f"of the wrapper, {100 * call['call_bound_ms'] / k7:.1f}% of the "
            f"kernels); host numpy {call['plain_ms']:.3f} ms")
        log(f"K7 seeds, {cell}: {m} points -> {ns} seeds, the same indices "
            f"as propagate_seeds; wrapper {call['seeds_call_ms']:.3f} ms, "
            f"K7's kernels {k7_s:.4f} ms (keys {keys['seeds_ms']:.4f}, walk "
            f"{walk['seeds_ms']:.4f}), bound "
            f"{call['seeds_call_bound_ms']:.5f} ms; host numpy "
            f"{call['seeds_plain_ms']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# --sweep: the grid kernels' times with compile-time constants changed
# ---------------------------------------------------------------------------


def patched_sources(variant: str, tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the kernel sources under ``tmp`` with the variant's
    ``NAME=VALUE`` items written into ``constexpr int NAME = ...;``; each
    name has to occur exactly once."""
    from piecewise_icp_torch.ops import _cuda

    dst = tmp / "csrc"
    shutil.copytree(_cuda.CSRC, dst)
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        pat = re.compile(rf"(constexpr int {re.escape(name)} = )[^;]+;")
        hits = 0
        for src in sorted(dst.iterdir()):
            text, n = pat.subn(rf"\g<1>{int(value)};", src.read_text())
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions found, expected 1")
    return dst


def k6_shapes(seed: int, tmp: str) -> dict:
    """K6's inputs at its five path shapes: ``unified``, the smoke pair's
    unified SOR rescue (``unified_rescue_inputs``); ``rescue_4096``,
    ``bench_torch.py``'s (4,096 random points of the voxelised bench epoch
    against all of it, k + 1 = 15, the SOR mean); ``rockfall``, the
    rockfall pair's staged SOR rescue (series written into ``tmp``);
    ``nogrid``, the sparse staged phase's cloud no grid fits, n x n, k + 1
    = 15, distances, the all-true mask; ``resolution``, the smoke epoch n x
    n, k = 2, distances, the all-true mask.  Each is (queries, targets, k,
    target mask, epilogue)."""
    import torch

    from bench_torch import KNN_RESCUE, bench_pair
    from piecewise_icp_torch.io import read_pcd
    from piecewise_icp_torch.ops.preprocess import voxel_downsample
    from piecewise_icp_torch.utils import rockfall
    from piecewise_icp_torch.utils.synth import make_pair, terrain_cloud

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    def all_true(p):
        return torch.ones(p.shape[0], dtype=torch.bool, device="cuda")

    down = voxel_downsample(bench_pair(seed)[0], RES)
    q = cuda(down)
    pick = np.sort(np.random.default_rng(0).choice(
        len(down), min(KNN_RESCUE, len(down)), replace=False))
    scans = rockfall.generate_rockfall(
        tmp, ROCKFALL_EPOCHS, seed=ROCKFALL_SEED, extent=ROCKFALL_EXTENT,
        res=ROCKFALL_RES)
    sor_grid, bad = rockfall_rescue_inputs(
        read_pcd(os.path.join(scans, sorted(os.listdir(scans))[0])))
    # the cloud of sparse_staged_phase with its far point
    rng = np.random.default_rng(seed + 3)
    c1 = make_pair(rng, PARAMS, n_side=N_SIDE, extent=EXTENT)[0]
    nogrid = cuda(np.concatenate([
        voxel_downsample(_with_sparse_points(rng, c1), RES),
        np.full((1, 3), 1e4, np.float32)]))
    epoch = cuda(terrain_cloud(np.random.default_rng(seed), n_side=N_SIDE,
                               extent=EXTENT))
    return {
        "unified": (*unified_rescue_inputs(seed), SOR_K + 1, None,
                    "sor_mean"),
        "rescue_4096": (q[cuda(pick)], q, SOR_K + 1, None, "sor_mean"),
        "rockfall": (bad, sor_grid.points, SOR_K + 1, None, "sor_mean"),
        "nogrid": (nogrid, nogrid, SOR_K + 1, all_true(nogrid), "dist"),
        "resolution": (epoch, epoch, 2, all_true(epoch), "dist"),
    }


def kernel_times(variant: str, seed: int) -> dict:
    """K1-K4 and K4's whole loop at the smoke epoch's shapes, built from the
    sources as they are (``base``) or with constants replaced.  For each:
    ``single``, the median of 5 calls between CUDA events (the wrapper's
    host work included); ``back_to_back``, the mean of 30 calls enqueued
    without a wait (where a kernel is shorter than its wrapper this measures
    the wrapper); ``device``, the time a call of the port's own kernels
    under the profiler, and ``launches``, the kernels and copies a call
    puts on the device (PyTorch's included), with ``rows`` the device time
    a call of each of the port's kernels by name; ``sm_mhz``, the SM clock
    sampled every 100 ms meanwhile.  K6 is timed the same at its five path
    shapes (``k6_shapes``), each with its bound and share under ``k6``.
    ``sig`` hashes K3's t2 and counts, K4's labels after three rounds, K1's
    ids and distances at both shapes and K6's outputs at its five: equal
    across variants that compute the same function (``kRangeWalk=0``, the
    floor of K1's launch, meets no candidate and does not).  A variant
    with ``kKnnTally=1`` calls K6 once at each shape instead, and its
    kernel prints a line of counts a call (``knn_tally``): candidates, the
    queries' steps at which a group passed, the insertions, the SMs used
    and the blocks' mean duration beside the kernel's span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piecewise_icp_torch.models.piecewise_icp import _cell_order, \
        _stage1_percentile
    from piecewise_icp_torch.models.segmentation_device import _seg_h
    from piecewise_icp_torch.ops import _cuda, nn_cuda, seg_cuda
    from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid

    def back_to_back_ms(fn, reps: int = 30) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def on_device(fn, reps: int = 20) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU]
        ours = [e for e in rows if port_kernel(e.key)]
        return {"device": sum(e.self_device_time_total
                              for e in ours) / 1e3 / reps,
                "launches": sum(e.count for e in rows) / reps,
                "rows": {port_kernel(e.key): e.self_device_time_total
                         / 1e3 / reps for e in ours}}

    with tempfile.TemporaryDirectory() as tmp:
        if variant != "base":
            _cuda.CSRC = patched_sources(variant, pathlib.Path(tmp))
            _cuda.BUILD_ROOT = pathlib.Path(tmp) / "_build"
        _cuda.lib()
        dev = torch.device("cuda")
        p1, p2 = smoke_epochs(seed)
        grid = CellGrid.from_index(build_grid(p1, _seg_h(KNN_NORMALS, RES)),
                                   dev)
        all_q = torch.ones(len(p1), dtype=torch.bool, device=dev)
        ks = seg_cuda._seg_stats_kernel(grid, all_q, KNN_NORMALS)
        t2, nk = ks[:, 1], seg_cuda.normals_from_stats(ks)
        seed_idx, qall, inv, h2, state = propagation_inputs(grid, all_q, nk,
                                                            t2, 3)
        # K1 at its two shapes (stage 1: cell-sorted queries, h = 4 res;
        # planning: file order, h = DTinit), the kernel's wrapper and the
        # public call with whatever elementwise passes follow it
        index1 = build_grid(p1, 4.0 * RES)
        grid1 = CellGrid.from_index(index1, dev)
        q1 = torch.from_numpy(p2[_cell_order(p2, index1)]).to(dev)
        grid_p = CellGrid.from_index(build_grid(p1, DT_INIT), dev)
        q_p = torch.from_numpy(p2).to(dev)
        fns = {
            "range_nn1": lambda: nn_cuda._range_nn1_kernel(q1, all_q, grid1),
            "range_nn1_plan": lambda: nn_cuda._range_nn1_kernel(q_p, all_q,
                                                                grid_p),
            "range_nn1_call": lambda: nn_cuda.range_nn1(q1, all_q, grid1),
            "range_nn1_call_plan": lambda: nn_cuda.range_nn1(q_p, all_q,
                                                             grid_p),
            # the caller of the first shape, no query left unresolved
            "stage1_percentile": lambda: _stage1_percentile(q1, all_q, grid1,
                                                            0.75),
            "knn_sorted": lambda: nn_cuda._knn_sorted_kernel(grid, all_q,
                                                             SOR_K + 1),
            "seg_stats": lambda: seg_cuda._seg_stats_kernel(grid, all_q,
                                                            KNN_NORMALS),
            "prop_round": lambda: seg_cuda._prop_round_kernel(
                grid, qall, all_q, state, inv, h2, False),
            "prop_round_adopt": lambda: seg_cuda._prop_round_kernel(
                grid, qall, all_q, state, inv, h2, True),
        }
        # a tree from before the loop moved onto the card is timed by this
        # script too (copied into it): it has the rounds only
        if hasattr(seg_cuda, "_propagate_kernel"):
            fns["propagate"] = lambda: seg_cuda._propagate_kernel(
                grid, nk, t2, all_q, seed_idx, SV, 256)
        k1 = b"".join(a.cpu().numpy().tobytes()
                      for g, qq in ((grid1, q1), (grid_p, q_p))
                      for a in nn_cuda.range_nn1(qq, all_q, g)[:2])
        k6_in = k6_shapes(seed, tmp)
        k6 = {}
        for name, (q, t, k, m, ep) in k6_in.items():
            fns[f"knn_brute_{name}"] = (
                lambda q=q, t=t, k=k, m=m, ep=ep:
                nn_cuda._knn_brute_kernel(q, t, k, m, ep))
            live = t.shape[0] if m is None else int(m.sum())
            k6[name] = {"nq": q.shape[0], "nt": t.shape[0], "k": k,
                        **knn_brute_bound(q.shape[0], t.shape[0],
                                          q.shape[0] * live, m is not None,
                                          1 if ep == "sor_mean" else k)}
        k6_out = b"".join(fns[f"knn_brute_{name}"]().cpu().numpy().tobytes()
                          for name in k6_in)
        sig = hashlib.sha1(ks[:, :2].cpu().numpy().tobytes()
                           + state[:, 6].cpu().numpy().tobytes()
                           + k1 + k6_out).hexdigest()[:12]
        if "kKnnTally=1" in variant:
            # the kernel prints its counts: one call a shape
            for name in k6_in:
                fns[f"knn_brute_{name}"]()
                torch.cuda.synchronize()
            return {"variant": variant, "card": nvidia_smi_line(),
                    "sig": sig, "k6": k6}
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        ms = {name: {"single": time_ms(fn),
                     "back_to_back": back_to_back_ms(fn),
                     **on_device(fn)} for name, fn in fns.items()}
        clocks.terminate()
        mhz = [int(v) for v in clocks.communicate(timeout=30)[0].split()
               if v.isdigit()]
    for name, v in k6.items():
        v["share_pct"] = 100 * v["bound_ms"] / ms[f"knn_brute_{name}"][
            "single"]
    return {"variant": variant, "card": nvidia_smi_line(), "sig": sig,
            "sm_mhz": {"samples": len(mhz),
                       "median": statistics.median(mhz) if mhz else None,
                       "min": min(mhz, default=None)},
            "ms": ms, "k6": k6}


# the phases ``--only`` may name (those that need no kernel timings)
ONLY_PHASES = {"reproducible": reproducible_phase, "variants": variants_phase,
               "change_screen": change_screen_phase,
               "exports_hooks": exports_hooks_phase, "capi": capi_phase,
               "pair": pair_phase, "sharded": sharded_phase,
               "rockfall": rockfall_phase, "fleet": fleet_phase,
               "bench": bench_phase, "voxel": voxel_phase}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=sorted(ONLY_PHASES),
                    help="build the kernels and run only these phases of "
                    "the smoke (no JSON record)")
    ap.add_argument("--sweep", nargs="+", metavar="VARIANT",
                    help="time the grid kernels only, one JSON line a "
                    "variant: 'base', or NAME=VALUE[,NAME=VALUE...] written "
                    "into the constexpr int constants of a copy of csrc/")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    if args.sweep:
        if len(args.sweep) == 1:
            print(json.dumps(kernel_times(args.sweep[0], args.seed)),
                  flush=True)
            return 0
        # a process a variant: each loads a library of its own
        for variant in args.sweep:
            done = subprocess.run([sys.executable, __file__, "--seed",
                                   str(args.seed), "--sweep", variant])
            if done.returncode != 0:
                return done.returncode
        return 0
    from piecewise_icp_torch.ops import _cuda

    smi = nvidia_smi_line()
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if pathlib.Path("/usr/local/cuda/bin/nvcc").exists() else None)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc {nvcc or 'not found'}")

    t0 = time.perf_counter()
    lib_path = _cuda.build()
    nvcc_s = ("cached" if _cuda.build_seconds is None
              else f"{_cuda.build_seconds:.2f}")
    log(f"kernel library {lib_path.relative_to(_cuda.BUILD_ROOT.parent)} "
        f"ready in {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    _cuda.lib()

    if args.only:
        for name in args.only:
            ONLY_PHASES[name](args.seed)
        log(f"chip_smoke: phases {args.only} passed")
        return 0
    kern = kernel_phases(args.seed)
    kern["nn1_brute"] = k5_phase(args.seed)
    # K7's numbers: the synthetic cell's shape as the campaign's, the
    # rockfall cell's as the rockfall phase's
    voxel = voxel_phase(args.seed)
    kern.update(voxel["synthetic"])
    k6_resolution = resolution_check(args.seed)
    k6_unified = unified_rescue_check(args.seed)
    pair_phase(args.seed)
    staged_pair_phase(args.seed)
    k6_nogrid = sparse_staged_phase(args.seed)
    rockfall = rockfall_phase(args.seed)
    for name, row in voxel["rockfall"].items():
        rockfall[name].update(row)
    # K6's path is the rockfall pair's staged SOR: its main numbers are
    # those of the rescue there, its other shapes suffixed
    kern["knn_brute"] = {
        **{k: v for k, v in rockfall["knn_brute"].items()
           if k != "launches"},
        **{f"{k}_nogrid": v for k, v in k6_nogrid.items()},
        **{f"{k}_resolution": v for k, v in k6_resolution.items()},
        **{f"{k}_unified": v for k, v in k6_unified.items()}}
    reproducible_phase(args.seed)
    variants_phase(args.seed)
    change_screen_phase(args.seed)
    exports_hooks_phase(args.seed)
    capi_phase(args.seed)
    sharded_phase(args.seed)
    launches = four_d_phase(args.seed, kern["nn1_brute"]["ms"])
    fleet = fleet_phase(args.seed)
    bench_phase(args.seed)
    foreign = _foreign_modules()
    require(not foreign, f"JAX or the JAX package was imported: {foreign}")

    # each kernel's launches in the campaign and its numbers at the
    # campaign's shapes (K6: in the rockfall phase, at the rescue's shape);
    # "_rockfall": its launches in the rockfall phase and its numbers at
    # that path's shapes; "launches_fleet": its launches in each worker of
    # the fleets of 1, 2 and 4
    launches["knn_brute"] = rockfall["knn_brute"]["launches"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(launches.get(name, 0)), **kern[name],
         **{f"{k}_rockfall": v for k, v in rockfall[name].items()
            if k != "library_ms"},
         "launches_fleet": fleet[name]}
        for name, (src, rep) in REPLACES.items()]}
    for k in record["kernels"]:
        path = "rockfall phase" if k["name"] == "knn_brute" else "campaign"
        log(f"{k['name']}: {k['launches']} launches in the {path}, "
            f"{k['ms']:.3f} ms against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}): {100 * k['bound_ms'] / k['ms']:.1f}% of it"
            + (f"; {50 * k['bound_ms'] / k['ms']:.1f}% were the operations "
               f"counted against the data sheet's 67e12 a second"
               if k["bound_by"] == "operations" else ""))
        log(f"{k['name']}, rockfall shape: {k['launches_rockfall']} "
            f"launches in the phase, {k['ms_rockfall']:.3f} ms against a "
            f"bound of {k['bound_ms_rockfall']:.4f} ms "
            f"({k['bound_by_rockfall']}): "
            f"{100 * k['bound_ms_rockfall'] / k['ms_rockfall']:.1f}% of it")
        if "ms_plan" in k:
            log(f"{k['name']}, planning shape: {k['ms_plan']:.3f} ms against "
                f"a bound of {k['bound_ms_plan']:.4f} ms "
                f"({k['bound_by_plan']}): "
                f"{100 * k['bound_ms_plan'] / k['ms_plan']:.1f}% of it")
    print(json.dumps(record), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
