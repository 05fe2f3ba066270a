"""PyTorch port, the inner-ICP variants and the change screen held against
the JAX package: ``point_to_plane_icp`` under each objective and weighting,
the whole core loop under each on the JAX package's own patch sets, the
JAX package's truth bounds for the variants, the change screen's keep mask
on one scene, and a core run with the screen on a scene with a sub-LoD
change."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from piecewise_icp_tpu.models.icp import \
    point_to_plane_icp as j_point_to_plane_icp
from piecewise_icp_tpu.models.piecewise_icp import \
    _change_screen as j_change_screen
from piecewise_icp_tpu.models.piecewise_icp import \
    piecewise_icp as j_piecewise_icp
from piecewise_icp_tpu.models.segmentation import PatchSet as JPatchSet
from piecewise_icp_tpu.models.segmentation_device import \
    preprocess_segment_device as j_preprocess_segment_device
from piecewise_icp_tpu.ops.preprocess import \
    voxel_downsample as j_voxel_downsample
from piecewise_icp_tpu.ops.transform import apply_transform_np

from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models.icp import point_to_plane_icp
from piecewise_icp_torch.models.piecewise_icp import (_change_screen,
                                                      piecewise_icp)
from piecewise_icp_torch.models.segmentation import PatchSet

from test_torch_core import corner_gap, jax_patch_sets  # noqa: F401
from util import make_pair, small_test_config

PARAMS = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
VARIANTS = [("reference", "uniform"), ("symmetric", "uniform"),
            ("reference", "inverse_variance"),
            ("symmetric", "inverse_variance")]
# the sub-LoD change of the screen's scenes: a square block, 15% of the
# area (the leak fraction of the JAX package's refine tests), 2 mm
LEAK_FRAC = 0.15
LEAK_M = 2e-3


def assert_core_matches(got, ref, pts):
    """The tolerances of ``test_torch_core.test_core_loop_matches_jax``."""
    assert got.num_patches == ref.num_patches
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.dt_series, ref.dt_series, rtol=1e-4)
    assert corner_gap(got.trans_mat, ref.trans_mat, pts) < 1e-4
    np.testing.assert_allclose(np.diag(got.vcm), np.diag(ref.vcm),
                               rtol=1e-3)
    assert got.final_n_stable == pytest.approx(ref.final_n_stable, abs=2)
    assert (got.stable_point_mask == ref.stable_point_mask).mean() > 0.99


def run_both(cfg, p1, p2, shift):
    """The JAX package's core and the port's on the same patch sets."""
    args = (p1.points, p2.points, cfg.res1, cfg.res2)
    ref = j_piecewise_icp(*args, cfg, patches1=p1, patches2=p2,
                          lattice_shift=shift)
    got = piecewise_icp(*args, config_from_jax(cfg),
                        patches1=PatchSet.from_numpy(p1),
                        patches2=PatchSet.from_numpy(p2),
                        lattice_shift=shift, device="cpu")
    return got, ref


@pytest.mark.parametrize("variant,weighting", VARIANTS,
                         ids=["-".join(v) for v in VARIANTS])
def test_point_to_plane_icp_matches_jax(jax_patch_sets, variant, weighting):
    """One inner ICP from the patch sets' misaligned centroids (every
    fourth source centroid masked out)."""
    _, p1, p2, _, _ = jax_patch_sets
    mask = np.arange(p2.num_patches) % 4 != 0
    weighted = weighting == "inverse_variance"
    tv = (p1.std_ct ** 2).astype(np.float32) if weighted else None
    sv = (p2.std_bp ** 2).astype(np.float32) if weighted else None
    kw = dict(max_iterations=100, transformation_eps=1e-8, fitness_eps=1e-6,
              symmetric=variant == "symmetric")
    m1 = np.ones(p1.num_patches, bool)
    t_ref, it_ref = j_point_to_plane_icp(
        jnp.asarray(p1.centroids), jnp.asarray(p1.normals), jnp.asarray(m1),
        jnp.asarray(p2.centroids), jnp.asarray(mask),
        source_normals=jnp.asarray(p2.normals),
        target_var=None if tv is None else jnp.asarray(tv),
        source_var=None if sv is None else jnp.asarray(sv), **kw)

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))

    t_got, it_got = point_to_plane_icp(
        t(p1.centroids), t(p1.normals), t(m1), t(p2.centroids), t(mask),
        source_normals=t(p2.normals), target_var=t(tv), source_var=t(sv),
        **kw)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=1e-5)
    assert abs(it_got - int(it_ref)) <= 1
    # the transform really moved the source
    assert np.abs(np.asarray(t_ref)[:3, 3]).max() > 1e-3


@pytest.mark.parametrize("variant,weighting", VARIANTS[1:],
                         ids=["-".join(v) for v in VARIANTS[1:]])
def test_core_loop_variants_match_jax(jax_patch_sets, variant, weighting):
    """The staged loop with the variant from the stage-2 transition on and
    the weighting in every stage, on the JAX package's patch sets."""
    cfg, p1, p2, shift, _ = jax_patch_sets
    cfg = cfg.__class__(**{**cfg.__dict__, "icp_variant": variant,
                           "icp_weighting": weighting})
    got, ref = run_both(cfg, p1, p2, shift)
    assert_core_matches(got, ref, p2.points)


@pytest.mark.parametrize("field,values", [
    ("icp_variant", ("reference", "symmetric")),
    ("icp_weighting", ("uniform", "inverse_variance"))])
def test_variants_meet_the_jax_package_bounds(rng, field, values):
    """The JAX package's own bounds for the variants
    (``tests/test_models.py::TestSymmetricVariant``), on the port: below
    2 mm mean, and not materially worse than the default."""
    c1, c2, t_true = make_pair(rng, PARAMS)
    errs = {}
    for v in values:
        cfg = config_from_jax(small_test_config(**{field: v}))
        res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg, device="cpu")
        m = res.trans_mat @ t_true
        errs[v] = np.linalg.norm(
            apply_transform_np(c2.astype(np.float64), m)
            - c2.astype(np.float64), axis=1).mean()
    base, alt = errs[values[0]], errs[values[1]]
    assert alt < 2e-3
    factor = 2.0 if field == "icp_variant" else 1.5
    assert alt < factor * base + 2e-4


def _block(xy: np.ndarray) -> np.ndarray:
    """A square block at the corner of the smallest x and y, LEAK_FRAC of
    the bounding box's area."""
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    side = np.sqrt(LEAK_FRAC) * (hi - lo)
    return ((xy[:, 0] < lo[0] + side[0]) & (xy[:, 1] < lo[1] + side[1]))


def test_change_screen_keep_mask_matches_jax(rng):
    """Both packages' ``_change_screen`` on the same arrays: the refine
    tests' patch-centroid scene with its leak made one spatial block."""
    n = 400
    xy = rng.uniform(0, 2, size=(n, 2))
    z = 0.15 * np.sin(2 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    ct1 = np.column_stack([xy, z]).astype(np.float32)
    gx = 0.3 * np.cos(2 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
    gy = -0.225 * np.sin(2 * xy[:, 0]) * np.sin(1.5 * xy[:, 1])
    n1 = np.column_stack([-gx, -gy, np.ones(n)])
    n1 = (n1 / np.linalg.norm(n1, axis=1, keepdims=True)).astype(np.float32)
    ct2 = ct1 + rng.normal(scale=2e-4, size=(n, 3)).astype(np.float32)
    leak = _block(xy)
    ct2[leak] += (LEAK_M * n1[leak]).astype(np.float32)
    stable = np.ones(n, bool)
    stable[rng.choice(n, 20, replace=False)] = False
    fields = dict(
        points=ct1, labels=np.arange(n, dtype=np.int32), centroids=ct1,
        boundary=np.repeat(ct1[:, None], 6, axis=1), normals=n1,
        std_bp=rng.uniform(2e-4, 6e-4, n).astype(np.float32),
        std_ct=np.full(n, 1e-5, np.float32),
        counts=rng.integers(40, 160, n).astype(np.int32))
    jps, tps = JPatchSet(**fields), PatchSet(**fields)
    args = (ct1, n1, np.ones(n, bool), ct2, stable)
    kw = dict(k=6, z_thd=2.5, min_keep=4)
    want = j_change_screen(*args, jps, jps, **kw)
    got = _change_screen(*args, tps, tps, **kw)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    dropped = stable & ~got
    # the screen flags the block
    assert (dropped & leak).sum() > 0.5 * (stable & leak).sum()
    assert (dropped & leak).sum() > 0.7 * dropped.sum()


@pytest.fixture(scope="module")
def changed_patch_sets():
    """The JAX device branch's patch sets of a synthetic pair whose source
    has one block raised by LEAK_M (target-reduced frame)."""
    rng = np.random.default_rng(11)
    c1, c2, t_true = make_pair(rng, PARAMS)
    block = _block(c2[:, :2])
    c2 = c2.copy()
    c2[block, 2] += np.float32(LEAK_M)
    cfg = small_test_config(guard_enabled=False, robust_refine=False,
                            change_screen=True)
    out = []
    for c, res, sv in ((c1, cfg.res1, cfg.svsize1),
                       (c2, cfg.res2, cfg.svsize2)):
        ps, _, kept = j_preprocess_segment_device(
            j_voxel_downsample(c, res), res, cfg.sor_neighbors,
            cfg.sor_std_mult_pair, sv, cfg.knn_normals, cfg)
        out.append((ps, kept))
    (ps1, kept1), (ps2, _) = out
    shift = -kept1.astype(np.float64).mean(axis=0)
    return cfg, ps1.translated(shift), ps2.translated(shift), shift


def test_change_screen_core_matches_jax(changed_patch_sets):
    """``robust_refine=False, change_screen=True`` on the scene with a
    sub-LoD change: the screen drops patches, and the port's run agrees
    with the JAX package's."""
    cfg, p1, p2, shift = changed_patch_sets
    got, ref = run_both(cfg, p1, p2, shift)
    assert_core_matches(got, ref, p2.points)
    off = piecewise_icp(p1.points, p2.points, cfg.res1, cfg.res2,
                        config_from_jax(cfg.__class__(
                            **{**cfg.__dict__, "change_screen": False})),
                        patches1=PatchSet.from_numpy(p1),
                        patches2=PatchSet.from_numpy(p2),
                        lattice_shift=shift, device="cpu")
    assert got.final_n_stable < off.final_n_stable
    assert got.stable_ratio < off.stable_ratio


def test_change_screen_is_ignored_while_the_refine_runs(jax_patch_sets):
    """With the default ``robust_refine="auto"`` the refine owns the final
    block: ``change_screen=True`` gives the result of ``False``."""
    cfg, p1, p2, shift, _ = jax_patch_sets
    runs = [piecewise_icp(p1.points, p2.points, cfg.res1, cfg.res2,
                          config_from_jax(cfg.__class__(
                              **{**cfg.__dict__, "change_screen": screen})),
                          patches1=PatchSet.from_numpy(p1),
                          patches2=PatchSet.from_numpy(p2),
                          lattice_shift=shift, device="cpu")
            for screen in (False, True)]
    assert cfg.robust_refine == "auto"
    np.testing.assert_array_equal(runs[0].trans_mat, runs[1].trans_mat)
    np.testing.assert_array_equal(runs[0].vcm, runs[1].vcm)
    np.testing.assert_array_equal(runs[0].stable_point_mask,
                                  runs[1].stable_point_mask)
    assert runs[0].final_n_stable == runs[1].final_n_stable
