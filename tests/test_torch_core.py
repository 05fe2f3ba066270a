"""PyTorch port, the Piecewise-ICP core loop held against the JAX package
on the SAME patch sets: both packages' ``piecewise_icp`` are given the
PatchSets that the JAX package's device segmentation produced, so the
staged loop (classification, inner ICP, stage-1 percentile through K1's
plain version, DT schedule, robust refine, VCM) is compared apart from
segmentation."""

import importlib
import itertools

import numpy as np
import pytest
import torch

from piecewise_icp_tpu.models.piecewise_icp import \
    piecewise_icp as j_piecewise_icp
from piecewise_icp_tpu.models.segmentation_device import \
    preprocess_segment_device as j_preprocess_segment_device
from piecewise_icp_tpu.ops.preprocess import \
    voxel_downsample as j_voxel_downsample

from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models.pairwise import TargetState, register_pair
from piecewise_icp_torch.models.piecewise_icp import piecewise_icp
from piecewise_icp_torch.models.segmentation import PatchSet
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.ops.nn_cuda import nn1_brute, range_nn1
from piecewise_icp_torch.ops.transform import translation_matrix

from util import make_pair, small_test_config, terrain_cloud

# the module: the package's name ``piecewise_icp`` is the function, as in
# the JAX package
core_mod = importlib.import_module("piecewise_icp_torch.models.piecewise_icp")

PARAMS = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])


def corners(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(axis=0), points.max(axis=0)
    return np.array([[(lo, hi)[b][i] for i, b in enumerate(c)]
                     for c in itertools.product((0, 1), repeat=3)])


def corner_gap(t_a, t_b, pts) -> float:
    """Largest displacement between two transforms at the AABB corners."""
    c = np.c_[corners(pts), np.ones(8)]
    return float(np.linalg.norm((c @ t_a.T - c @ t_b.T)[:, :3],
                                axis=1).max())


@pytest.fixture(scope="module")
def jax_patch_sets():
    """The JAX device branch's patch sets of a synthetic pair, in the
    target-reduced frame (as register_pair builds them)."""
    rng = np.random.default_rng(7)
    c1, c2, _ = make_pair(rng, PARAMS)
    cfg = small_test_config(guard_enabled=False)
    out = []
    for c, res, sv in ((c1, cfg.res1, cfg.svsize1),
                       (c2, cfg.res2, cfg.svsize2)):
        down = j_voxel_downsample(c, res)
        ps, _, kept = j_preprocess_segment_device(
            down, res, cfg.sor_neighbors, cfg.sor_std_mult_pair, sv,
            cfg.knn_normals, cfg)
        out.append((ps, kept))
    (ps1, kept1), (ps2, kept2) = out
    shift = -kept1.astype(np.float64).mean(axis=0)
    p1, p2 = ps1.translated(shift), ps2.translated(shift)
    return cfg, p1, p2, shift, c2


def test_core_loop_matches_jax(jax_patch_sets):
    cfg, p1, p2, shift, c2 = jax_patch_sets
    args = (p1.points, p2.points, cfg.res1, cfg.res2, cfg)
    ref = j_piecewise_icp(*args, patches1=p1, patches2=p2,
                          lattice_shift=shift)
    got = piecewise_icp(*args[:4], config_from_jax(cfg),
                        patches1=PatchSet.from_numpy(p1),
                        patches2=PatchSet.from_numpy(p2),
                        lattice_shift=shift, device="cpu")
    assert got.num_patches == ref.num_patches
    # same schedule: same number of outer iterations, DT series to a
    # relative 1e-4 (float32 sums in another order move it slightly)
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.dt_series, ref.dt_series, rtol=1e-4)
    # transforms within 0.1 mm at the bounding-box corners of the source
    assert corner_gap(got.trans_mat, ref.trans_mat, p2.points) < 1e-4
    # VCM diagonals to a relative 1e-3
    np.testing.assert_allclose(np.diag(got.vcm), np.diag(ref.vcm),
                               rtol=1e-3)
    assert got.final_n_stable == pytest.approx(ref.final_n_stable, abs=2)
    assert (got.stable_point_mask == ref.stable_point_mask).mean() > 0.99


def test_register_pair_reuses_carried_states(jax_patch_sets):
    """TargetState.from_numpy carries the JAX patch sets into the port's
    register_pair (target reuse and source re-framing) — the same core
    run as above, de-reduced."""
    cfg, p1, p2, shift, _ = jax_patch_sets
    ts = TargetState.from_numpy(shift, p1.points, p1, cfg.res1)
    # the source state is segmented in the SAME frame: delta shift 0
    ss = TargetState.from_numpy(shift, p2.points, p2, cfg.res2)
    cfg = config_from_jax(cfg)
    out = register_pair(None, None, cfg, target_state=ts, source_state=ss,
                        device="cpu")
    core = piecewise_icp(p1.points, p2.points, cfg.res1, cfg.res2, cfg,
                         patches1=PatchSet.from_numpy(p1),
                         patches2=PatchSet.from_numpy(p2),
                         lattice_shift=shift, device="cpu")
    want = (translation_matrix(-shift) @ core.trans_mat
            @ translation_matrix(shift))
    np.testing.assert_allclose(out.trans_mat, want, atol=1e-12)
    np.testing.assert_array_equal(out.vcm, core.vcm)


def _stage1_percentile_by_flags(cloud2, pt_stable, grid, percentile, budget):
    """The stage-1 percentile as it was computed before K1 counted its
    unresolved queries: every step from the flags (``nonzero``, a rescued
    mask, the three-way ``ok``), whatever their number."""
    _, d, resolved, strict = range_nn1(cloud2, pt_stable, grid)
    bad = pt_stable & ~resolved
    bad_idx = torch.nonzero(bad).squeeze(1)
    n_bad = bad_idx.shape[0]
    u = min(budget, n_bad)
    rescued = torch.zeros_like(bad)
    if u:
        sel = bad_idx[:u]
        _, d[sel] = nn1_brute(cloud2[sel], grid.points)
        rescued[sel] = True
    ok = resolved | ~pt_stable | rescued
    d_ok = torch.where(ok, d, torch.inf)
    idx = torch.clamp((pt_stable.sum().to(torch.float32)
                       * torch.tensor(percentile, dtype=torch.float32)
                       ).to(torch.int64), 0, d_ok.shape[0] - 1)
    d_grid = torch.sort(d_ok).values[idx]
    exact = torch.tensor(True) if n_bad <= u \
        else torch.as_tensor(strict) & (idx < (ok & pt_stable).sum())
    return d_grid, exact, n_bad


@pytest.mark.parametrize("case,percentile", [
    ("none_unresolved", 0.75), ("some_unresolved", 0.75),
    ("over_budget", 0.75), ("over_budget", 0.97)])
def test_stage1_percentile_from_the_count(monkeypatch, case, percentile):
    """``_stage1_percentile`` reads K1's one count and skips the rescue
    where it is 0; d75, exact and n_unresolved equal (tolerance 0: the
    same float32 operations on the CPU) what the flags alone gave before:
    with no unresolved query, with some, and with more than the rescue
    budget (the first ones by index are rescued; at the 97th percentile
    the index lands beyond the resolved block and the result is not
    exact)."""
    rng = np.random.default_rng(11)
    t = terrain_cloud(rng, n_side=50).astype(np.float64)
    t = (t - t.mean(axis=0)).astype(np.float32)
    grid = CellGrid.from_index(build_grid(t, 0.12), torch.device("cpu"))
    cloud2 = t + rng.normal(scale=0.004, size=t.shape).astype(np.float32)
    n_far = {"none_unresolved": 0, "some_unresolved": 40,
             "over_budget": 200}[case]
    far = rng.choice(len(t), n_far, replace=False)
    cloud2[far, 2] += rng.uniform(0.3, 0.6, n_far).astype(np.float32)
    stable = rng.uniform(size=len(t)) > 0.2
    stable[far] = True
    budget = 64
    monkeypatch.setattr(core_mod, "_PCT_RESCUE", budget)
    calls = []
    monkeypatch.setattr(core_mod, "nn1_brute",
                        lambda *a, **k: calls.append(1) or nn1_brute(*a, **k))
    cloud2, stable = torch.from_numpy(cloud2), torch.from_numpy(stable)
    d75, exact, n_bad = core_mod._stage1_percentile(cloud2, stable, grid,
                                                    percentile)
    want = _stage1_percentile_by_flags(cloud2, stable, grid, percentile,
                                       budget)
    assert n_bad == want[2] == n_far
    assert float(d75) == float(want[0])
    assert bool(exact) == bool(want[1])
    assert bool(exact) == (case != "over_budget" or percentile == 0.75)
    assert len(calls) == (1 if n_far else 0)   # no rescue without a need
