"""PyTorch port, the brute 1-NN (K5) and the preprocessing of the staged
path and of auto DT-init / auto resolution, held against the JAX package:
K5's plain version against ``nn1_pallas`` in interpret mode and the XLA
``nn1``, ``percentile_c2c``, ``estimate_resolution``, the overlap ratios,
adaptive pair planning, and the staged SOR branches (the clouds the JAX
package hands to its host statistic stay on the tensors' device here).

Distance tolerance: 2 ulp, as in ``test_torch_nn.py`` (XLA on the CPU
contracts the squared distance into fused multiply-adds; the port rounds
every product and sum separately, bit-identical to its CUDA kernels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu.io import write_pcd
from piecewise_icp_tpu.models.four_d import \
    adaptive_pair_sequence as j_adaptive_pair_sequence
from piecewise_icp_tpu.ops import preprocess as jpre
from piecewise_icp_tpu.ops.grid_nn import build_grid as jbuild_grid
from piecewise_icp_tpu.ops.nn import nn1 as jnn1
from piecewise_icp_tpu.ops.nn_pallas import nn1_pallas

from piecewise_icp_torch.models.four_d import adaptive_pair_sequence
from piecewise_icp_torch.ops import nn_cuda
from piecewise_icp_torch.ops import preprocess as tpre
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid

from util import terrain_cloud

CPU = torch.device("cpu")
ULP = 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _outlier_cloud(rng, n_side, outliers=0.01):
    """A terrain scan with a few points lifted off the surface."""
    pts = terrain_cloud(rng, n_side=n_side).astype(np.float64)
    n_out = int(outliers * len(pts))
    sel = rng.choice(len(pts), n_out, replace=False)
    pts[sel, 2] += rng.uniform(0.03, 0.1, n_out)
    return pts.astype(np.float32)


def _sparse_cloud(rng, n_side, n_sparse):
    """A terrain scan with ``n_sparse`` isolated points above it, thinning
    out with height: each one's (k+1)-th neighbour lies far beyond the SOR
    grid's cell size, so none of them resolves on the grid."""
    pts = terrain_cloud(rng, n_side=n_side)
    z0 = float(pts[:, 2].max()) + 0.2
    sparse = np.stack([rng.uniform(0.0, 2.0, n_sparse),
                       rng.uniform(0.0, 2.0, n_sparse),
                       z0 + rng.exponential(1.0, n_sparse)], axis=1)
    return np.concatenate([pts, sparse.astype(np.float32)])


def _drift_series(rng, tmp_path):
    """The advancing-target series of ``tests/test_4d.py``: seven noisy
    copies of one random cloud under a random-walk drift."""
    base = (rng.uniform(size=(3000, 3)) * 2).astype(np.float32)
    drift = np.zeros(3, np.float32)
    files, clouds = [], []
    for k in range(7):
        drift += rng.normal(scale=0.02, size=3).astype(np.float32)
        c = (base + drift
             + rng.normal(scale=0.002, size=base.shape).astype(np.float32))
        p = tmp_path / f"Epoch_{k + 1:03d}.pcd"
        write_pcd(p, c)
        files.append(str(p))
        clouds.append(c)
    return files, clouds


@pytest.fixture()
def k5_inputs(rng):
    """1,500 queries near 5,000 targets, the last 50 targets exact copies
    of earlier ones (ties), 10% of targets and of queries masked."""
    t = rng.normal(size=(4950, 3)).astype(np.float32)
    dup = rng.choice(4950, 50, replace=False)
    t = np.concatenate([t, t[dup]])
    q = np.concatenate([
        t[dup] + rng.normal(scale=1e-4, size=(50, 3)).astype(np.float32),
        rng.normal(size=(1450, 3)).astype(np.float32)])
    tm = rng.uniform(size=5000) > 0.1
    tm[dup] = True                     # the tied originals stay valid
    qm = rng.uniform(size=1500) > 0.1
    qm[:50] = True
    return q, t, qm, tm


class TestNn1Brute:
    def test_plain_matches_pallas_and_xla(self, k5_inputs):
        q, t, qm, tm = k5_inputs
        ti, td = (a.numpy() for a in nn_cuda.nn1_brute(
            _t(q), _t(t), q_mask=_t(qm), t_mask=_t(tm)))
        assert ti.dtype == np.int64 and td.dtype == np.float32
        assert np.isinf(td[~qm]).all() and np.isfinite(td[qm]).all()
        assert (ti >= 0).all()
        for fn in (nn1_pallas, jnn1):
            kw = dict(interpret=True) if fn is nn1_pallas else {}
            ji, jd = (np.asarray(a) for a in fn(
                jnp.asarray(q), jnp.asarray(t), q_mask=jnp.asarray(qm),
                t_mask=jnp.asarray(tm), **kw))
            np.testing.assert_array_equal(ti[qm], ji[qm])
            np.testing.assert_array_max_ulp(td[qm], jd[qm], maxulp=ULP)
            assert np.isinf(jd[~qm]).all()
        # ties go to the lowest index: the originals, never their copies
        assert (ti[:50] < 4950).all()
        assert tm[ti[qm]].all()

    def test_plain_raw_outputs(self, k5_inputs):
        """The plain version's raw form, which the kernel reproduces bit
        for bit on the card: (-1, inf) for masked queries and for queries
        with no valid target."""
        q, t, qm, tm = k5_inputs
        idx, d2 = nn_cuda.nn1_brute_plain(_t(q), _t(t), _t(qm), _t(tm))
        assert (idx[~_t(qm)] == -1).all() and torch.isinf(d2[~_t(qm)]).all()
        none = torch.zeros(5000, dtype=torch.bool)
        idx, d2 = nn_cuda.nn1_brute_plain(_t(q), _t(t), None, none)
        assert (idx == -1).all() and torch.isinf(d2).all()
        # the public wrapper keeps the reference contract: idx >= 0, +inf
        i, d = nn_cuda.nn1_brute(_t(q), _t(t), t_mask=none)
        assert (i == 0).all() and torch.isinf(d).all()


class TestPercentileResolution:
    def test_percentile_c2c(self, rng):
        t = terrain_cloud(rng, n_side=60)
        s = terrain_cloud(rng, n_side=60) + np.float32(0.003)
        tm = rng.uniform(size=len(t)) > 0.05
        sm = rng.uniform(size=len(s)) > 0.3
        for masks in ((None, None), (tm, sm)):
            jm = [None if m is None else jnp.asarray(m) for m in masks]
            tmk = [None if m is None else _t(m) for m in masks]
            for p in (0.5, 0.75):
                want = np.float32(jpre.percentile_c2c(
                    jnp.asarray(t), jnp.asarray(s), p, t_mask=jm[0],
                    s_mask=jm[1]))
                got = np.float32(tpre.percentile_c2c(
                    _t(t), _t(s), p, t_mask=tmk[0], s_mask=tmk[1]))
                np.testing.assert_array_max_ulp(got, want, maxulp=ULP)

    def test_estimate_resolution(self, rng):
        pts = terrain_cloud(rng, n_side=60)
        mask = rng.uniform(size=len(pts)) > 0.2
        for m in (None, mask):
            want = jpre.estimate_resolution(
                jnp.asarray(pts), None if m is None else jnp.asarray(m))
            got = tpre.estimate_resolution(
                _t(pts), None if m is None else _t(m))
            assert abs(got - want) <= 1e-5 * want


class TestOverlap:
    def test_overlap_ratios_match_jax(self, rng, tmp_path):
        _, clouds = _drift_series(rng, tmp_path)
        dt = 0.03
        for i, j in ((0, 1), (0, 3), (2, 6)):
            t, s = clouds[i], clouds[j]
            n = len(s)
            want = float(jpre.overlap_ratio(jnp.asarray(t), jnp.asarray(s),
                                            dt))
            want_g = float(jpre.overlap_ratio_grid(jbuild_grid(t, dt),
                                                   jnp.asarray(s), dt))
            got = tpre.overlap_ratio(_t(t), _t(s), dt)
            got_g = tpre.overlap_ratio_grid(
                CellGrid.from_index(build_grid(t, dt), CPU), _t(s), dt)
            assert got == got_g           # grid and brute agree exactly
            for w in (want, want_g):
                assert abs(got - w) <= 1.0 / n
        with pytest.raises(ValueError):
            tpre.overlap_ratio_grid(
                CellGrid.from_index(build_grid(t, 0.05), CPU), _t(s), dt)

    def test_adaptive_plan_matches_jax(self, rng, tmp_path):
        files, _ = _drift_series(rng, tmp_path)
        want, _ = j_adaptive_pair_sequence(files, 0, 0.03, 0.75)
        got, ratios = adaptive_pair_sequence(files, 0, 0.03, 0.75,
                                             device="cpu")
        assert got == want
        assert len(set(got.values())) > 1      # the target advances
        assert all(0.0 <= r <= 1.0 for r in ratios.values())


class TestStagedSor:
    def test_sor_filter_mask_matches_jax(self, rng):
        pts = _outlier_cloud(rng, n_side=60)        # 3,600 <= 4,096 points
        want = np.asarray(jpre.sor_filter_mask(jnp.asarray(pts), None,
                                               k=14, std_mult=2.7))
        got = tpre.sor_filter_mask(_t(pts), None, k=14,
                                   std_mult=2.7).numpy()
        assert (got == want).mean() >= 0.999
        assert (~got).sum() > 0

    def test_sor_keep_mask_device_matches_jax(self, rng):
        pts = _outlier_cloud(rng, n_side=80)        # 6,400 points
        res = 0.025
        want = jpre.sor_keep_mask_device(pts, res, 14, 2.7, interpret=True)
        got = tpre.sor_keep_mask_device(pts, res, 14, 2.7, CPU)
        assert want is not None and got is not None
        assert got.shape == (len(pts),)
        assert (got == want).mean() >= 0.999
        assert (~got).sum() > 0

    def test_preprocess_cloud_branches(self, rng):
        """Both sides of the 4,096-point switch: device SOR above it, brute
        k-NN at or below it, each on the voxel-downsampled cloud."""
        for n_side, res in ((80, 0.02), (60, 0.02)):
            pts = _outlier_cloud(rng, n_side=n_side)
            down = tpre.voxel_downsample(pts, res)
            if len(down) > 4096:
                keep = tpre.sor_keep_mask_device(down, res, 14, 2.7, CPU)
            else:
                keep = tpre.sor_filter_mask(_t(down), None, 14, 2.7).numpy()
            got = tpre.preprocess_cloud(pts, res, 14, 2.7, CPU)
            np.testing.assert_array_equal(got, down[keep])
            assert 0 < (~keep).sum() < 0.1 * len(down)

    @pytest.mark.parametrize("case", ["many_unresolved", "no_grid"])
    def test_declined_clouds_stay_on_device(self, rng, monkeypatch, case):
        """Where the JAX package hands the staged SOR to the native host
        statistic (more unresolved queries than its rescue budget, or no
        grid fits the extent), the port decides on the tensors' device:
        every unresolved query re-measured exactly, or the brute k-NN.
        Both equal the exact statistic of ``native.sor_mean_dist``."""
        from piecewise_icp_tpu import native

        res, k = 0.02, 14
        pts = _sparse_cloud(rng, n_side=64, n_sparse=4200)
        down = tpre.voxel_downsample(pts, res)
        if case == "many_unresolved":
            h = max(1.5 * np.sqrt((k + 1) / np.pi), 4.0) * res
            grid = CellGrid.from_index(build_grid(down, h), CPU)
            _, n_bad = tpre.sor_mask_sorted(
                grid, torch.ones(len(down), dtype=torch.bool), k, 2.7,
                rescue_max=0)
            assert n_bad > tpre._SOR_RESCUE
        else:
            def no_grid(*a, **kw):
                raise ValueError("extent too large for a dense grid")

            monkeypatch.setattr(tpre, "build_grid", no_grid)
        mean_d = native.sor_mean_dist(down, k).astype(np.float64)
        want = mean_d <= mean_d.mean() + 2.7 * mean_d.std(ddof=1)
        got = tpre.sor_keep_mask_device(down, res, k, 2.7, CPU)
        assert (got == want).mean() >= 0.999
        assert (~got).sum() > 0
        np.testing.assert_array_equal(
            tpre.preprocess_cloud(pts, res, k, 2.7, CPU), down[got])
