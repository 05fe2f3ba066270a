"""PyTorch port, segmentation held against the JAX package: the plain
versions of K3 (seg_stats) and K4 (prop_round / propagate_rounds) against
the Pallas kernels in interpret mode, and the whole unified SOR +
segmentation (preprocess_segment_device)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu.config import PiecewiseICPConfig
from piecewise_icp_tpu.models.segmentation_device import \
    preprocess_segment_device as j_preprocess_segment_device
from piecewise_icp_tpu.ops.grid_nn import build_grid as jbuild_grid
from piecewise_icp_tpu.ops.grid_nn import slab_padded_self_join
from piecewise_icp_tpu.ops.nn_pallas import (_KQT, _TPB,
                                             pad_query_target_rows)
from piecewise_icp_tpu.ops.seg_pallas import (_prop_round,
                                              _seg_stats_padded,
                                              propagate_rounds, seg_stats)

from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models.segmentation_device import (
    preprocess_segment_device, propagate_seeds)
from piecewise_icp_torch.ops import seg_cuda
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.ops.preprocess import voxel_downsample

from util import terrain_cloud

CPU = torch.device("cpu")
K = 45
RES = 2.0 / 64          # point spacing of a 64 x 64 terrain scan
SV = 10 * RES
H = float(max(1.2 * np.sqrt(K / np.pi), 3.0) * RES)


@pytest.fixture()
def layout(rng):
    """A 4096-point centred terrain scan in both packages' layouts."""
    pts = terrain_cloud(rng, n_side=64).astype(np.float64)
    pts = (pts - pts.mean(axis=0)).astype(np.float32)
    grid = jbuild_grid(pts, H)
    sp = slab_padded_self_join(grid, lane=_KQT, block=_KQT * _TPB,
                               tile_multiple=_TPB)
    cg = CellGrid.from_index(build_grid(pts, H), CPU)
    return grid, sp, cg


def _jax_common(grid, sp):
    return (jnp.asarray(sp.points), jnp.asarray(sp.real_mask),
            jnp.zeros((1,), jnp.int32), jnp.asarray(grid.origin),
            jnp.asarray(grid.dims, jnp.int32))


def _padded(sp, a, fill=0.0):
    out = np.full((len(sp.points),) + a.shape[1:], fill, np.float32)
    out[sp.pos_map] = a
    return out


class TestSegStats:
    def test_plain_matches_pallas(self, layout):
        grid, sp, cg = layout
        n = grid.n_real
        rows_map = sp.pos_map
        qp, t_rows = pad_query_target_rows(jnp.asarray(sp.points),
                                           jnp.asarray(sp.points), _TPB)
        j_rows = np.asarray(_seg_stats_padded(
            qp, jnp.asarray(sp.ranges), t_rows, K, H * H,
            interpret=True))[rows_map]
        pts, qm, starts, origin, dims = _jax_common(grid, sp)
        jt2, jcnt, jnrm, _ = (np.asarray(a) for a in seg_stats(
            pts, qm, starts, origin, dims, H, K,
            host_ranges=(jnp.asarray(sp.ranges), jnp.asarray(sp.covered))))
        jt2, jcnt, jnrm = jt2[rows_map], jcnt[rows_map], jnrm[rows_map]

        all_q = torch.ones(n, dtype=torch.bool)
        rows = seg_cuda.seg_stats_rows(cg, all_q, K).numpy()
        t2, cnt, nrm = (a.numpy() for a in seg_cuda.seg_stats(cg, all_q, K))
        assert sp.covered.all()
        # the histogram edges are the same f32 arithmetic on both sides;
        # XLA's FMA contraction moves a d2 by an ulp at most (see
        # test_torch_nn), which flips no bin on this input: t2 and counts
        # are equal
        np.testing.assert_array_equal(t2, jt2)
        np.testing.assert_array_equal(cnt, jcnt)
        # moment sums, summed in another order: relative 1e-5 of each
        # moment's natural scale (count * h, count * h^2)
        ok = np.ones(n, bool)
        c = cnt[:, None]
        scale = np.concatenate([c.repeat(3, 1) * H, c.repeat(6, 1) * H * H],
                               axis=1)
        assert (np.abs(rows[ok, 2:11] - j_rows[ok, 2:11])
                <= 1e-5 * scale + 1e-12).all()
        # normals: same direction, |n . n'| >= 1 - 1e-5
        dots = np.abs((nrm[ok] * jnrm[ok]).sum(axis=1))
        assert (dots >= 1 - 1e-5).all()


class TestPropagation:
    @pytest.fixture()
    def inputs(self, layout):
        grid, sp, cg = layout
        n = grid.n_real
        all_q = torch.ones(n, dtype=torch.bool)
        t2, _, nrm = seg_cuda.seg_stats(cg, all_q, K)
        seeds = propagate_seeds(grid.points[:n], SV)
        return grid, sp, cg, t2, nrm, seeds, all_q

    @pytest.mark.parametrize("adopt", [False, True])
    def test_one_round_matches_pallas(self, inputs, adopt):
        grid, sp, cg, t2, nrm, seeds, all_q = inputs
        state = seg_cuda.init_state(cg.points, nrm, torch.from_numpy(
            seeds.astype(np.int64)))
        inv, h2 = float(0.4 / SV), H * H
        qall = torch.cat([cg.points, nrm, t2[:, None],
                          torch.zeros_like(t2)[:, None]], dim=1)
        for _ in range(2):      # a partly propagated state
            state, _ = seg_cuda.prop_round(cg, qall, all_q, state, inv, h2,
                                           False)
        new, chg = seg_cuda.prop_round(cg, qall, all_q, state, inv, h2,
                                       adopt)

        qp, t_rows = pad_query_target_rows(jnp.asarray(sp.points),
                                           jnp.asarray(sp.points), _TPB)
        tp = max(t_rows.shape[1], qp.shape[0])
        j_state = np.full((8, tp), -1.0, np.float32)
        j_state[:, sp.pos_map] = state.numpy().T
        j_qall = np.zeros((qp.shape[0], 8), np.float32)
        j_qall[:, :3] = np.asarray(qp)
        j_qall[:len(sp.points), 3:7] = _padded(
            sp, qall[:, 3:7].numpy())
        j_new, j_chg = _prop_round(jnp.asarray(j_qall),
                                   jnp.asarray(j_state),
                                   jnp.asarray(sp.ranges), t_rows, inv,
                                   adopt, h2, interpret=True)
        j_lab = np.asarray(j_new)[6, sp.pos_map]
        lab = new[:, 6].numpy()
        # same seeds => labels are seed-slot ids on both sides; XLA's FMA
        # contraction can move a d2 or metric tie by an ulp: >= 99%
        assert (lab == j_lab).mean() >= 0.99
        assert abs(int(chg) - int(float(j_chg))) <= 0.01 * len(lab) + 1

    def test_propagate_rounds_matches_pallas(self, inputs):
        grid, sp, cg, t2, nrm, seeds, all_q = inputs
        lab, rounds = seg_cuda.propagate_rounds(
            cg, nrm, t2, all_q, torch.from_numpy(seeds.astype(np.int64)),
            SV)
        pts, qm, starts, origin, dims = _jax_common(grid, sp)
        j_lab, j_rounds = propagate_rounds(
            pts, jnp.asarray(_padded(sp, nrm.numpy())),
            jnp.asarray(_padded(sp, t2.numpy())), qm,
            jnp.asarray(sp.pos_map[seeds]), starts, origin, dims, H, SV,
            host_ranges=(jnp.asarray(sp.ranges), jnp.asarray(sp.covered)))
        j_lab = np.asarray(j_lab)[sp.pos_map]
        agree = (lab.numpy() == j_lab).mean()
        assert agree >= 0.99, agree
        assert (lab.numpy() >= 0).mean() > 0.99


def test_preprocess_segment_device_matches_jax(rng):
    pts = terrain_cloud(rng, n_side=70)
    res = 2.0 / 70
    cfg = PiecewiseICPConfig(res1=res, res2=res, svsize1=10 * res,
                             svsize2=10 * res)
    down = voxel_downsample(pts, res)
    args = (down, res, cfg.sor_neighbors, cfg.sor_std_mult_pair, 10 * res,
            cfg.knn_normals, cfg)
    ps, nsv, kept = preprocess_segment_device(
        *args[:-1], config_from_jax(cfg), device=CPU)
    jps, jnsv, jkept = j_preprocess_segment_device(*args)
    np.testing.assert_array_equal(kept, jkept)
    assert abs(ps.num_patches - jps.num_patches) <= 0.02 * jps.num_patches
    # match patches by centroid; matched patches agree to 1e-5 m
    # (centroids) and 1e-4 rad (normals)
    d2 = ((ps.centroids[:, None].astype(np.float64)
           - jps.centroids[None].astype(np.float64)) ** 2).sum(-1)
    j = d2.argmin(axis=1)
    dist = np.sqrt(d2[np.arange(len(j)), j])
    matched = dist < 1e-3
    assert matched.mean() >= 0.98
    assert (dist[matched] <= 1e-5).all()
    a = ps.normals[matched].astype(np.float64)
    b = jps.normals[j[matched]].astype(np.float64)
    # angle via atan2(|a x b|, |a . b|): arccos loses ~3e-4 rad near 1
    ang = np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                     np.abs((a * b).sum(axis=1)))
    assert (ang <= 1e-4).all()
