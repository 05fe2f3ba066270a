"""PyTorch port, host and device ops held against the JAX package:
transforms, the closed-form 3x3 eigensolve, segment reductions, the grid
index, and the port's independence from JAX."""

import importlib
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from piecewise_icp_tpu.ops.eigh3 import eigvals3 as j_eigvals3, \
    smallest_eigvec3 as j_smallest_eigvec3
from piecewise_icp_tpu.ops import segment_ops as jseg
from piecewise_icp_tpu.ops import transform as jtr
from piecewise_icp_tpu.ops.grid_nn import build_grid as jbuild_grid

from piecewise_icp_torch.ops import segment_ops as tseg
from piecewise_icp_torch.ops import transform as ttr
from piecewise_icp_torch.ops.grid_nn import build_grid as tbuild_grid

from util import terrain_cloud

# the module: the package's name ``eigh3`` is the function, as in the JAX
# package
teig = importlib.import_module("piecewise_icp_torch.ops.eigh3")


def _covs(rng, n=500):
    """Random symmetric PSD 3x3 covariances plus degenerate ones (zero,
    isotropic, rank one)."""
    a = rng.normal(size=(n, 5, 3)).astype(np.float32)
    a[:, :, 2] *= rng.uniform(0.0, 0.05, size=(n, 1)).astype(np.float32)
    cov = np.einsum("nki,nkj->nij", a, a) / 5.0
    rank1 = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    extra = np.stack([np.zeros((3, 3)), np.eye(3) * 0.7, rank1])
    return np.concatenate([cov, extra]).astype(np.float32)


class TestEigh3:
    def test_eigvals_match_jax(self, rng):
        cov = _covs(rng)
        ref = np.asarray(j_eigvals3(jnp.asarray(cov)))
        got = teig.eigvals3(torch.from_numpy(cov)).numpy()
        # float32 closed form, same operation order: within a few ulps of
        # the largest eigenvalue
        scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-30
        assert (np.abs(got - ref) <= 4e-6 * scale).all()

    def test_smallest_eigvec_match_jax_including_sign(self, rng):
        cov = _covs(rng)
        vals = j_eigvals3(jnp.asarray(cov))
        ref = np.asarray(j_smallest_eigvec3(jnp.asarray(cov), vals[..., 2]))
        got = teig.smallest_eigvec3(torch.from_numpy(cov),
                                    torch.from_numpy(np.array(vals[..., 2]))
                                    ).numpy()
        # same direction AND same sign (the reference's sign choice)
        dots = (got * ref).sum(axis=1)
        assert (dots >= 1 - 1e-5).all()
        # degenerate input (zero matrix) falls back to (0, 0, 1)
        np.testing.assert_array_equal(got[-3], [0.0, 0.0, 1.0])
        np.testing.assert_array_equal(ref[-3], [0.0, 0.0, 1.0])


class TestSegmentOps:
    @pytest.fixture()
    def data(self, rng):
        n, s = 2000, 37
        ids = rng.integers(-1, s, size=n).astype(np.int32)
        # integer-valued coordinates force ties in arg-max / arg-min
        pts = rng.integers(0, 20, size=(n, 3)).astype(np.float32)
        return pts, ids, s

    def test_sums_counts_means(self, data):
        pts, ids, s = data
        tp, ti = torch.from_numpy(pts), torch.from_numpy(ids)
        np.testing.assert_array_equal(
            tseg.segment_count(ti, s).numpy(),
            np.asarray(jseg.segment_count(jnp.asarray(ids), s)))
        # integer-valued data: sums are exact in any order
        np.testing.assert_array_equal(
            tseg.segment_sum(tp, ti, s).numpy(),
            np.asarray(jseg.segment_sum(jnp.asarray(pts), jnp.asarray(ids),
                                        s)))
        np.testing.assert_allclose(
            tseg.segment_mean(tp, ti, s).numpy(),
            np.asarray(jseg.segment_mean(jnp.asarray(pts), jnp.asarray(ids),
                                         s)), rtol=1e-6)

    @pytest.mark.parametrize("axis", [0, 1, 2])
    def test_first_occurrence_argmax_argmin(self, data, axis):
        pts, ids, s = data
        v = pts[:, axis]
        for tf, jf in ((tseg.segment_argmax, jseg.segment_argmax),
                       (tseg.segment_argmin, jseg.segment_argmin)):
            got = tf(torch.from_numpy(v), torch.from_numpy(ids), s).numpy()
            ref = np.asarray(jf(jnp.asarray(v), jnp.asarray(ids), s))
            np.testing.assert_array_equal(got, ref)

    def test_cov3(self, rng):
        n, s = 3000, 23
        ids = rng.integers(-1, s, size=n).astype(np.int32)
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        cov, mean, cnt = (a.numpy() for a in tseg.segment_cov3(
            torch.from_numpy(pts), torch.from_numpy(ids), s))
        rc, rm, rn = (np.asarray(a) for a in jseg.segment_cov3(
            jnp.asarray(pts), jnp.asarray(ids), s))
        np.testing.assert_array_equal(cnt, rn)
        # f32 sums of ~130 terms: 1e-5 relative
        np.testing.assert_allclose(mean, rm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(cov, rc, rtol=1e-5, atol=1e-6)


class TestTransforms:
    def test_host_copies_equal(self, rng):
        for _ in range(20):
            x = rng.normal(scale=[0.3, 0.3, 0.3, 5, 5, 5])
            m = ttr.params_to_matrix(x)
            np.testing.assert_array_equal(m, jtr.params_to_matrix(x))
            np.testing.assert_array_equal(ttr.matrix_to_angles(m),
                                          jtr.matrix_to_angles(m))
            np.testing.assert_array_equal(ttr.matrix_to_params_gon(m),
                                          jtr.matrix_to_params_gon(m))
            pts = rng.normal(size=(50, 3))
            np.testing.assert_array_equal(ttr.apply_transform_np(pts, m),
                                          jtr.apply_transform_np(pts, m))
        np.testing.assert_array_equal(ttr.translation_matrix([1, 2, 3]),
                                      jtr.translation_matrix([1, 2, 3]))

    def test_device_ops_match_jax(self, rng):
        x = rng.normal(scale=[0.01, 0.01, 0.01, 0.01, 0.01, 0.01]
                       ).astype(np.float32)
        m = np.array(jtr.params_to_matrix_jax(jnp.asarray(x)))
        got_m = ttr.params_to_matrix_torch(torch.from_numpy(x)).numpy()
        # float32 trigonometry and 3x3 products: 1e-6 absolute
        np.testing.assert_allclose(got_m, m, atol=1e-6)
        pts = (rng.normal(size=(400, 3)) * 2.0).astype(np.float32)
        mask = rng.uniform(size=400) > 0.2
        np.testing.assert_allclose(
            ttr.apply_transform(torch.from_numpy(pts),
                                torch.from_numpy(m)).numpy(),
            np.asarray(jtr.apply_transform(jnp.asarray(pts),
                                           jnp.asarray(m))),
            atol=2e-6)
        lo, hi = ttr.masked_aabb(torch.from_numpy(pts),
                                 torch.from_numpy(mask))
        jlo, jhi = jtr.masked_aabb(jnp.asarray(pts), jnp.asarray(mask))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        bb = ttr.bounding_box_corner_change(lo, hi, torch.from_numpy(m))
        jbb = jtr.bounding_box_corner_change(jlo, jhi, jnp.asarray(m))
        np.testing.assert_allclose(float(bb), float(jbb), rtol=1e-5)


class TestBuildGrid:
    @pytest.mark.parametrize("h", [0.02, 0.0227, 0.1])
    def test_bit_identical(self, rng, h):
        pts = terrain_cloud(rng, n_side=60)
        a, b = tbuild_grid(pts, h), jbuild_grid(pts, h)
        for f in ("points", "ids", "cell_starts", "origin"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
        assert (a.dims, a.h, a.n_real) == (b.dims, b.h, b.n_real)


def test_port_imports_without_jax():
    """``import piecewise_icp_torch`` (and every module of the slice)
    succeeds with jax blocked: the port never imports JAX."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib"):
            sys.modules[name] = None
        import piecewise_icp_torch
        from piecewise_icp_torch.models import pairwise, piecewise_icp
        from piecewise_icp_torch.models import chaining, four_d, kalman
        from piecewise_icp_torch.ops import nn_cuda, preprocess, seg_cuda
        from piecewise_icp_torch import __main__
        assert piecewise_icp_torch.register_pair
        assert piecewise_icp_torch.piecewise_icp_4d_call
        print("ok")
    """)
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
