"""PyTorch port, the Piecewise-ICP core loop held against the JAX package
on the SAME patch sets: both packages' ``piecewise_icp`` are given the
PatchSets that the JAX package's device segmentation produced, so the
staged loop (classification, inner ICP, stage-1 percentile through K1's
plain version, DT schedule, robust refine, VCM) is compared apart from
segmentation."""

import itertools

import numpy as np
import pytest

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
from piecewise_icp_torch.ops.transform import translation_matrix

from util import make_pair, small_test_config

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
