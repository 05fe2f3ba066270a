"""PyTorch port, the whole pairwise registration held against the JAX
package's device branch (composed by hand: on the CPU the JAX package's
own ``register_pair`` takes its native branch), against the truth of a
synthetic pair, and through the reference-style file entry point."""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu.io import formats, write_pcd
from piecewise_icp_tpu.models.piecewise_icp import \
    piecewise_icp as j_piecewise_icp
from piecewise_icp_tpu.models.segmentation_device import \
    preprocess_segment_device as j_preprocess_segment_device
from piecewise_icp_tpu.ops.preprocess import \
    estimate_resolution as j_estimate_resolution
from piecewise_icp_tpu.ops.preprocess import \
    voxel_downsample as j_voxel_downsample
from piecewise_icp_tpu.ops.transform import (apply_transform_np,
                                             translation_matrix)

from piecewise_icp_torch import piecewise_icp_pair_call
from piecewise_icp_torch.__main__ import main as cli_main
from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models.pairwise import (prepare_target,
                                                 register_pair)
from piecewise_icp_torch.models.piecewise_icp import piecewise_icp
from piecewise_icp_torch.models.segmentation import build_patches
from piecewise_icp_torch.ops.preprocess import preprocess_cloud

from util import make_pair, small_test_config

PARAMS = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])


def jax_device_branch(c1, c2, cfg) -> np.ndarray:
    """register_pair's TPU branch with the JAX package's functions:
    voxel grid + unified SOR/segmentation for both clouds, reduction to the
    target centroid, the core loop, de-reduction (no acceptance guard)."""
    mult = cfg.sor_std_mult_pair
    out = []
    for c, res, sv in ((c1, cfg.res1, cfg.svsize1),
                       (c2, cfg.res2, cfg.svsize2)):
        ps, _, kept = j_preprocess_segment_device(
            j_voxel_downsample(c, res), res, cfg.sor_neighbors, mult, sv,
            cfg.knn_normals, cfg)
        out.append((ps, kept))
    (ps1, kept1), (ps2, kept2) = out
    shift = -kept1.astype(np.float64).mean(axis=0)
    p1, p2 = ps1.translated(shift), ps2.translated(shift)
    core = j_piecewise_icp(p1.points, p2.points, cfg.res1, cfg.res2, cfg,
                           patches1=p1, patches2=p2, lattice_shift=shift)
    return (translation_matrix(-shift) @ core.trans_mat
            @ translation_matrix(shift))


def truth_residual(t_est, t_true, c2):
    """Displacement left by T_est @ T_true (ideally the identity)."""
    m = t_est @ t_true
    return np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                          - c2.astype(np.float64), axis=1)


def corner_gap(t_a, t_b, pts) -> float:
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = np.array([[(lo, hi)[b][i] for i, b in enumerate(k)]
                  for k in itertools.product((0, 1), repeat=3)])
    c = np.c_[c, np.ones(8)]
    return float(np.linalg.norm((c @ t_a.T - c @ t_b.T)[:, :3],
                                axis=1).max())


@pytest.fixture()
def pair(rng):
    return make_pair(rng, PARAMS)


def test_register_pair_matches_jax_device_branch(pair):
    c1, c2, t_true = pair
    cfg = small_test_config(guard_enabled=False)
    ref = jax_device_branch(c1, c2, cfg)
    got = register_pair(c1, c2, config_from_jax(cfg), device="cpu")
    # the two packages agree within 0.5 mm at the source's box corners
    assert corner_gap(got.trans_mat, ref, c2) < 5e-4
    # and both meet the truth bounds of the JAX package's own tests
    for t in (got.trans_mat, ref):
        disp = truth_residual(t, t_true, c2)
        assert disp.mean() < 2e-3 and disp.max() < 5e-3
    assert got.vcm.shape == (6, 6) and (np.diag(got.vcm) > 0).all()


@pytest.mark.parametrize("entry", ["call", "cli", "cli_symmetric"])
def test_pair_call_writes_report(pair, tmp_path, entry):
    c1, c2, t_true = pair
    write_pcd(tmp_path / "Epoch_000.pcd", c1)
    write_pcd(tmp_path / "Epoch_001.pcd", c2)
    cfg = small_test_config(path1=str(tmp_path / "Epoch_000.pcd"),
                            path2=str(tmp_path / "Epoch_001.pcd"))
    conf = tmp_path / "config_pair.txt"
    cfg.to_reference_file(conf)
    prefix = str(tmp_path / "PairReg_")
    if entry == "call":
        assert piecewise_icp_pair_call(str(conf), prefix, device="cpu")
    else:
        extra = ["--icp-variant", "symmetric"] if entry == "cli_symmetric" \
            else []
        assert cli_main(["pair", "--config", str(conf), "--out", prefix,
                         "--device", "cpu", *extra]) == 0
    rep = formats.read_trans_matrix_report(prefix + "TransMatrix.txt")
    assert (tmp_path / "PairReg_RegisteredSourceCloud.pcd").exists()
    disp = truth_residual(rep["trans_mat"], t_true, c2)
    assert disp.mean() < 2e-3 and disp.max() < 5e-3
    assert (np.diag(rep["vcm"]) > 0).all()


@pytest.mark.parametrize("over", [dict(icp_variant="symmetric"),
                                  dict(icp_weighting="inverse_variance"),
                                  dict(change_screen=True)],
                         ids=["symmetric", "inverse_variance",
                              "change_screen"])
def test_out_of_slice_paths_raise(pair, over):
    """The configuration paths beyond the reference objective run and agree
    with the JAX package's device branch: the symmetric objective, the
    inverse-variance weights, and the change screen (which the default
    refine supersedes in both packages)."""
    c1, c2, t_true = pair
    cfg = small_test_config(guard_enabled=False, **over)
    ref = jax_device_branch(c1, c2, cfg)
    got = register_pair(c1, c2, config_from_jax(cfg), device="cpu")
    assert corner_gap(got.trans_mat, ref, c2) < 5e-4
    for t in (got.trans_mat, ref):
        disp = truth_residual(t, t_true, c2)
        assert disp.mean() < 2e-3 and disp.max() < 5e-3


def test_auto_resolution_and_dtinit_match_jax(rng):
    """``isSetResSVsize: 0`` and ``isSetDTinit: 0``: the port estimates
    both resolutions and the initial DT itself; the JAX device branch is
    given its own estimated resolutions (SV size 10 x res).  4,900 points
    a cloud: above the unified path's floor after voxelisation."""
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=70)
    over = dict(guard_enabled=False, set_dtinit=False)
    got = register_pair(c1, c2, config_from_jax(small_test_config(
        set_res_svsize=False, **over)), device="cpu")
    r1, r2 = (j_estimate_resolution(jnp.asarray(c)) for c in (c1, c2))
    ref = jax_device_branch(c1, c2, small_test_config(
        res1=r1, res2=r2, svsize1=10 * r1, svsize2=10 * r2, **over))
    assert got.core.patches1 is not None
    assert corner_gap(got.trans_mat, ref, c2) < 5e-4
    for t in (got.trans_mat, ref):
        disp = truth_residual(t, t_true, c2)
        assert disp.mean() < 2e-3 and disp.max() < 5e-3


def test_staged_prep_pair(rng):
    """A 3,600-point pair lies under the unified path's 4,096-point floor:
    the staged path (SOR, then segmentation) registers it."""
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=60)
    cfg = small_test_config(guard_enabled=False)
    assert len(j_voxel_downsample(c1, cfg.res1)) < 4096
    got = register_pair(c1, c2, config_from_jax(cfg), device="cpu")
    disp = truth_residual(got.trans_mat, t_true, c2)
    assert disp.mean() < 2e-3 and disp.max() < 5e-3
    assert got.core.num_patches[0] >= cfg.min_stable_patches


def _pair_entry_points():
    from piecewise_icp_torch.models import (pairwise, segmentation,
                                            segmentation_device)
    from piecewise_icp_torch.ops import preprocess

    return [pairwise.prepare_target, pairwise.register_pair,
            pairwise.piecewise_icp_pair_call, piecewise_icp,
            segmentation.build_patches,
            segmentation_device.segment_patches_device,
            segmentation_device.preprocess_segment_device,
            preprocess.preprocess_cloud]


@pytest.mark.parametrize("fn", _pair_entry_points(),
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    """Every public entry point of the pair path runs on the card unless
    the caller names another device."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_call_without_device_raises_without_a_card(pair, tmp_path):
    """No quiet drop to the CPU: where no GPU is visible, a call that names
    no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    c1, c2, _ = pair
    cfg = config_from_jax(small_test_config(
        path1=str(tmp_path / "Epoch_000.pcd"),
        path2=str(tmp_path / "Epoch_001.pcd")))
    write_pcd(cfg.path1, c1)
    write_pcd(cfg.path2, c2)
    conf = tmp_path / "config_pair.txt"
    cfg.to_reference_file(conf)
    calls = (lambda: register_pair(c1, c2, cfg),
             lambda: prepare_target(c1, cfg, cfg.sor_std_mult_pair),
             lambda: piecewise_icp_pair_call(str(conf),
                                             str(tmp_path / "out_")),
             lambda: piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg),
             lambda: build_patches(c1, cfg.svsize1),
             lambda: preprocess_cloud(c1, cfg.res1))
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not (tmp_path / "out_TransMatrix.txt").exists()
