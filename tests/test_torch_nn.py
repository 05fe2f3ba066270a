"""PyTorch port, nearest-neighbour ops held against the JAX package: the
plain versions of K1 (range_nn1) and K2 (knn_sorted) against the Pallas
kernels in interpret mode, the SOR decision, and the brute 1-NN / k-NN
distances.

Distance tolerance: XLA on the CPU contracts (dx*dx + dy*dy) + dz*dz into
fused multiply-adds; the port rounds every product and sum separately
(bit-identical to its CUDA kernels, built with -fmad=false).  Squared
distances then differ by up to ~1.5 ulp, and distances after the square
root by up to 2 ulp (ULP below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu.ops.grid_nn import build_grid as jbuild_grid
from piecewise_icp_tpu.ops.grid_nn import slab_padded_self_join
from piecewise_icp_tpu.ops.nn import knn as jknn
from piecewise_icp_tpu.ops.nn import nn1 as jnn1
from piecewise_icp_tpu.ops.nn_pallas import (_KQT, _TPB, grid_knn_sorted,
                                             grid_range_query)
from piecewise_icp_tpu.ops.preprocess import _sor_mask_sorted

from piecewise_icp_torch.ops import nn_cuda
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.ops.preprocess import sor_mask_sorted

from util import terrain_cloud

CPU = torch.device("cpu")
ULP = 2


def _cloud(rng, n_side=70, outliers=0.01):
    """A ~5k-point terrain scan with a few points lifted off the surface
    (SOR has something to remove)."""
    pts = terrain_cloud(rng, n_side=n_side).astype(np.float64)
    n_out = int(outliers * len(pts))
    sel = rng.choice(len(pts), n_out, replace=False)
    pts[sel, 2] += rng.uniform(0.03, 0.1, n_out)
    return (pts - pts.mean(axis=0)).astype(np.float32)


def _cell_sort(q, grid):
    cell = np.floor((q - grid.origin) / grid.h).astype(np.int64)
    d = grid.dims
    lin = ((np.clip(cell[:, 0], 0, d[0] - 1) * d[1]
            + np.clip(cell[:, 1], 0, d[1] - 1)) * d[2]
           + np.clip(cell[:, 2], 0, d[2] - 1))
    return q[np.argsort(lin, kind="stable")]


def _slab(pts, h):
    """The JAX package's main-path self-join layout (host ranges)."""
    grid = jbuild_grid(pts, h)
    sp = slab_padded_self_join(grid, lane=_KQT, block=_KQT * _TPB,
                               tile_multiple=_TPB)
    inv = np.full(len(sp.points), -1, np.int64)
    inv[sp.pos_map] = np.arange(grid.n_real)
    return grid, sp, inv


class TestRangeNN1:
    def test_plain_matches_pallas(self, rng):
        t = _cloud(rng)
        q = _cloud(rng) + np.float32(0.004)
        q = np.concatenate([q, (rng.uniform(-2, 2, (50, 3))
                                ).astype(np.float32)])
        grid = jbuild_grid(t, 0.1)
        q = _cell_sort(q, grid)
        qm = np.ones(len(q), bool)
        qm[::17] = False
        ji, jd, jr, strict = (np.asarray(a) for a in grid_range_query(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(grid.points),
            jnp.asarray(grid.cell_starts), jnp.asarray(grid.origin),
            jnp.asarray(grid.dims, jnp.int32),
            jnp.asarray(grid.h, jnp.float32)))
        ti, td, tr, tstrict = nn_cuda.range_nn1(
            torch.from_numpy(q), torch.from_numpy(qm),
            CellGrid.from_index(build_grid(t, 0.1), CPU))
        ti, td, tr = ti.numpy(), td.numpy(), tr.numpy()
        assert tstrict
        # resolved sets: the port resolves every query the Pallas kernel
        # does, and exactly the same ones where every tile was covered
        assert (tr | ~jr).all()
        if bool(strict):
            np.testing.assert_array_equal(tr, jr)
        real = jr & qm
        assert real.mean() > 0.5
        # distances of resolved queries within ULP; same nearest point
        np.testing.assert_array_max_ulp(td[real], jd[real], maxulp=ULP)
        np.testing.assert_array_equal(ti[real], ji[real])
        assert np.isinf(td[~qm]).all() and tr[~qm].all()


    @pytest.mark.parametrize("shape", ["stage1", "planning"])
    def test_counted_plain_matches_pallas(self, rng, shape):
        """The counted entry (what the kernel writes: distance, resolved
        flag, clamped index, the count of unresolved live queries) against
        ``grid_range_query`` at K1's two shapes: the stage-1 percentile's
        (cell-sorted queries, some masked, a fine grid) and adaptive
        planning's (h = a DTinit, queries in file order, no mask, some
        outside the target's box)."""
        t = _cloud(rng)
        if shape == "stage1":
            h = 0.1
            q = np.concatenate([_cloud(rng) + np.float32(0.004),
                                rng.uniform(-2, 2, (50, 3)
                                            ).astype(np.float32)])
            q = _cell_sort(q, jbuild_grid(t, h))
            qm = np.ones(len(q), bool)
            qm[::13] = False
            tqm = torch.from_numpy(qm)
        else:
            h = 0.15
            q = np.concatenate([_cloud(rng) + np.float32(0.02),
                                rng.uniform(-3, 3, (80, 3)
                                            ).astype(np.float32)])
            q = q[rng.permutation(len(q))]
            qm = np.ones(len(q), bool)
            tqm = None                       # no mask: every query live
        grid = jbuild_grid(t, h)
        ji, jd, jr, strict = (np.asarray(a) for a in grid_range_query(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(grid.points),
            jnp.asarray(grid.cell_starts), jnp.asarray(grid.origin),
            jnp.asarray(grid.dims, jnp.int32),
            jnp.asarray(grid.h, jnp.float32)))
        ti, td, tr, tstrict, tn = nn_cuda.range_nn1_counted(
            torch.from_numpy(q), tqm,
            CellGrid.from_index(build_grid(t, h), CPU))
        assert tstrict and tn.dtype == torch.int32 and tn.ndim == 0
        ti, td, tr = ti.numpy(), td.numpy(), tr.numpy()
        # the count is that of the flags, exactly
        assert int(tn) == int((qm & ~tr).sum())
        assert (tr | ~jr).all()
        if bool(strict):
            np.testing.assert_array_equal(tr, jr)
        real = jr & qm
        assert real.mean() > 0.5 and 0 < int(tn) < len(q)
        # distances of resolved queries within ULP (see the module's note);
        # the same nearest point
        np.testing.assert_array_max_ulp(td[real], jd[real], maxulp=ULP)
        np.testing.assert_array_equal(ti[real], ji[real])
        assert np.isinf(td[~qm]).all() and tr[~qm].all()
        assert (ti >= 0).all()
        # the public entry is the counted one without the count
        pi, pd, pr, pstrict = nn_cuda.range_nn1(
            torch.from_numpy(q), tqm,
            CellGrid.from_index(build_grid(t, h), CPU))
        np.testing.assert_array_equal(pi.numpy(), ti)
        np.testing.assert_array_equal(pd.numpy(), td)
        np.testing.assert_array_equal(pr.numpy(), tr)

    def test_no_query(self, rng):
        """No query at all: empty outputs and a count of 0."""
        g = CellGrid.from_index(build_grid(_cloud(rng), 0.1), CPU)
        i, d, r, _, n = nn_cuda.range_nn1_counted(
            torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool), g)
        assert i.shape == d.shape == r.shape == (0,) and int(n) == 0


class TestKnnSorted:
    def test_plain_matches_pallas(self, rng):
        pts = _cloud(rng)
        h, k = 0.13, 15
        grid, sp, inv = _slab(pts, h)
        ji, jd, jr = (np.asarray(a) for a in grid_knn_sorted(
            jnp.asarray(sp.points), jnp.asarray(sp.real_mask),
            jnp.asarray(sp.points), jnp.zeros((1,), jnp.int32),
            jnp.asarray(grid.origin), jnp.asarray(grid.dims, jnp.int32),
            jnp.asarray(grid.h, jnp.float32), k,
            host_ranges=(jnp.asarray(sp.ranges),
                         jnp.asarray(sp.covered))))
        rows = sp.pos_map
        ji, jd, jr = ji[rows], jd[rows], jr[rows]
        ji = np.where(ji >= 0, inv[np.clip(ji, 0, None)], -1)
        covered = sp.covered[rows // _KQT]

        n = grid.n_real
        cg = CellGrid.from_index(build_grid(pts, h), CPU)
        ti, td, tr = (a.numpy() for a in nn_cuda.knn_sorted(
            cg, torch.ones(n, dtype=torch.bool), k))
        assert (tr | ~jr).all()
        np.testing.assert_array_equal(tr[covered], jr[covered])
        assert jr.mean() > 0.9
        # resolved queries: same k neighbours, ascending, ties to the
        # lowest sorted id; distances within ULP
        np.testing.assert_array_max_ulp(td[jr], jd[jr], maxulp=ULP)
        np.testing.assert_array_equal(ti[jr], ji[jr])
        assert (ti[:, 0] == np.arange(n)).mean() > 0.99   # self first


class TestSor:
    def test_keep_mask_matches_pallas(self, rng):
        pts = _cloud(rng)
        h, sor_k, mult = 0.13, 14, 2.7
        grid, sp, _ = _slab(pts, h)
        keep_j, n_bad_j = _sor_mask_sorted(
            jnp.asarray(sp.points), jnp.asarray(sp.real_mask),
            jnp.asarray(sp.points), jnp.zeros((1,), jnp.int32),
            jnp.asarray(grid.origin), jnp.asarray(grid.dims, jnp.int32),
            jnp.asarray(grid.h, jnp.float32), sor_k,
            jnp.asarray(mult, jnp.float32), interpret=True,
            ranges=jnp.asarray(sp.ranges), covered=jnp.asarray(sp.covered))
        keep_j = np.asarray(keep_j)[sp.pos_map]
        n = grid.n_real
        keep_t, n_bad_t = sor_mask_sorted(
            CellGrid.from_index(build_grid(pts, h), CPU),
            torch.ones(n, dtype=torch.bool), sor_k, mult)
        keep_t = keep_t.numpy()
        # f32 global mean/std summed in another order can flip a point
        # sitting exactly at the threshold: >= 99.9% identical
        assert (keep_t == keep_j).mean() >= 0.999
        assert int(n_bad_j) >= n_bad_t >= 0
        assert (~keep_t).sum() > 0


class TestBrute:
    @pytest.mark.parametrize("masked", [False, True])
    def test_nn1_knn_match_jax(self, rng, masked):
        q = rng.normal(size=(700, 3)).astype(np.float32)
        t = rng.normal(size=(900, 3)).astype(np.float32)
        qm = np.ones(700, bool)
        tm = np.ones(900, bool)
        if masked:
            qm[::7] = False
            tm[::5] = False
        ji, jd = (np.asarray(a) for a in jnn1(
            jnp.asarray(q), jnp.asarray(t), q_mask=jnp.asarray(qm),
            t_mask=jnp.asarray(tm)))
        ti, td = (a.numpy() for a in nn_cuda.nn1_brute(
            torch.from_numpy(q), torch.from_numpy(t),
            q_mask=torch.from_numpy(qm), t_mask=torch.from_numpy(tm)))
        np.testing.assert_array_max_ulp(td, jd, maxulp=ULP)
        np.testing.assert_array_equal(ti[qm], ji[qm])
        # the port's brute k-NN returns the distances only (its callers use
        # nothing else): equal to JAX's knn distances of unmasked queries
        _, kd = (np.asarray(a) for a in jknn(
            jnp.asarray(q), jnp.asarray(t), 8, q_mask=jnp.asarray(qm),
            t_mask=jnp.asarray(tm)))
        tkd = nn_cuda.knn_distances(
            torch.from_numpy(q), torch.from_numpy(t), 8,
            t_mask=torch.from_numpy(tm)).numpy()
        assert tkd.shape == (700, 8)
        assert (np.diff(tkd, axis=1) >= 0).all()
        np.testing.assert_array_max_ulp(tkd[qm], kd[qm], maxulp=ULP)

    @pytest.mark.parametrize("form", ["gathered", "all_masked"])
    def test_rescue_form_matches_jax(self, rng, form):
        """The brute 1-NN as the stage-1 rescue of the core loop calls it:
        a gathered subset of the source points against the grid's sorted
        targets, of which some sit at the 1e30 sentinel and some are exact
        duplicates; no masks.  Held against the JAX package's chunked
        minimum (``models/piecewise_icp.py``: 512-row chunks of
        coordinate-difference squares under ``lax.map``) and its ``nn1``.
        An all-masked query set gives +inf everywhere."""
        import jax

        t = _cloud(rng)
        t[-60:] = t[:60]                                  # exact ties
        cloud2 = t[:-60] + rng.normal(
            scale=2e-3, size=(len(t) - 60, 3)).astype(np.float32)
        cloud2[:60] = t[:60]                   # distance 0 to a tied pair
        t[rng.choice(len(t) - 120, 40, replace=False) + 60] = 1e30
        sel = np.sort(rng.choice(len(cloud2), 1024, replace=False))
        sel[:60] = np.arange(60)
        q = cloud2[sel]
        if form == "all_masked":
            none = torch.zeros(len(q), dtype=torch.bool)
            i, d = nn_cuda.nn1_brute(torch.from_numpy(q),
                                     torch.from_numpy(t), q_mask=none)
            assert torch.isinf(d).all() and (i == 0).all()
            _, jd = jnn1(jnp.asarray(q), jnp.asarray(t),
                         q_mask=jnp.zeros(len(q), bool))
            assert np.isinf(np.asarray(jd)).all()
            return
        ti, td = (a.numpy() for a in nn_cuda.nn1_brute(
            torch.from_numpy(q), torch.from_numpy(t)))

        g_pts = jnp.asarray(t)

        def chunk_min(qc):
            d2 = jnp.zeros((qc.shape[0], g_pts.shape[0]), qc.dtype)
            for c in range(3):
                diff = qc[:, c][:, None] - g_pts[None, :, c]
                d2 = d2 + diff * diff
            return jnp.min(d2, axis=1)

        d2min = jax.lax.map(chunk_min,
                            jnp.asarray(q).reshape(2, 512, 3)).reshape(-1)
        jd_chunk = np.asarray(jnp.sqrt(jnp.maximum(d2min, 0.0)))
        ji, jd = (np.asarray(a) for a in jnn1(jnp.asarray(q), g_pts))
        np.testing.assert_array_max_ulp(td, jd_chunk, maxulp=ULP)
        np.testing.assert_array_max_ulp(td, jd, maxulp=ULP)
        assert np.isfinite(td).all()
        # ids agree off ties (a 2-ulp difference may reorder near-ties)
        off_tie = ti != ji
        assert off_tie.mean() <= 0.01
        np.testing.assert_array_max_ulp(
            np.linalg.norm(q[off_tie] - t[ti[off_tie]], axis=1),
            np.linalg.norm(q[off_tie] - t[ji[off_tie]], axis=1), maxulp=4)
        # exact ties go to the lowest index, the sentinel is never matched
        np.testing.assert_array_equal(ti[:60], np.arange(60))
        assert (t[ti, 0] < 1e29).all()
