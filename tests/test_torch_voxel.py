"""PyTorch port, the voxel grouping (K7, ``ops/voxel_cuda.py``): the
voxel-grid downsample and the supervoxel seed choice, bit for bit.

On the CPU the wrappers take the port's host numpy versions
(``ops/preprocess.py:voxel_downsample``,
``models/segmentation_device.py:propagate_seeds``); those are held against
the JAX package's functions, on small cases and on the inputs of the card's
tests.  On the card (``cuda``) K7 is held against the port's host versions
at the benchmark cells' shapes.  The card's tests import no JAX, so they run
with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_voxel.py
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from piecewise_icp_torch.io import read_pcd
from piecewise_icp_torch.models.segmentation_device import (
    _seg_h, propagate_seeds)
from piecewise_icp_torch.ops import _cuda
from piecewise_icp_torch.ops.grid_nn import build_grid
from piecewise_icp_torch.ops.preprocess import voxel_downsample
from piecewise_icp_torch.ops.voxel_cuda import voxel_centroids, voxel_seeds
from piecewise_icp_torch.utils.logging import GLOBAL_TIMER, gphase
from piecewise_icp_torch.utils.rockfall import generate_rockfall
from piecewise_icp_torch.utils.synth import terrain_cloud


def _jax_refs():
    """The JAX package's ``voxel_downsample`` and ``propagate_seeds``
    (imported here: the card's tests run without JAX)."""
    from piecewise_icp_tpu.models.segmentation_device import (
        propagate_seeds as j_propagate_seeds)
    from piecewise_icp_tpu.ops.preprocess import (
        voxel_downsample as j_voxel_downsample)

    return j_voxel_downsample, j_propagate_seeds


def _masked_seeds(seeds_fn, pts, res, origin=None, mask=None):
    """``seeds_fn`` (a ``propagate_seeds``) over the live points, as
    indices into ``pts`` (the unified path's gather)."""
    if mask is None:
        return seeds_fn(pts, res, origin=origin).astype(np.int64)
    live = np.flatnonzero(mask)
    return live[seeds_fn(pts[mask], res, origin=origin)]


def _assert_same(pts, leaf, res, origin=None, mask=None, device="cpu"):
    """Centroids (float32 bytes) and seeds (index lists) of ``pts`` on
    ``device`` equal the reference's: the JAX package's functions on the
    CPU, the port's host versions on the card."""
    down_fn, seeds_fn = ((voxel_downsample, propagate_seeds)
                         if torch.device(device).type == "cuda"
                         else _jax_refs())
    t = torch.from_numpy(np.ascontiguousarray(pts)).to(device)
    want = down_fn(pts, leaf)
    got = voxel_centroids(t, leaf).cpu().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    tm = None if mask is None else torch.from_numpy(mask).to(device)
    got_s = voxel_seeds(t, res, origin=origin, mask=tm).cpu().numpy()
    np.testing.assert_array_equal(
        got_s, _masked_seeds(seeds_fn, pts, res, origin, mask))
    return want, got_s


def _grid_lattice_offsets(mn, sv, offset):
    """The acceptance guard's seed origin: the world-aligned lattice moved
    back by the draw's offset modulo the supervoxel size."""
    base = np.floor(mn / sv) * sv
    return base - np.mod(np.asarray(offset, np.float64), sv)


def _case(name, rng):
    """(points, leaf, seed resolution, origin, mask) of one case."""
    cloud = rng.normal(scale=0.3, size=(3000, 3)).astype(np.float32)
    if name == "negative":
        return cloud - np.float32(5.0), 0.07, 0.2, None, None
    if name == "on_faces":
        # every coordinate a multiple of the leaf: points on voxel faces
        g = rng.integers(-20, 20, size=(3000, 3)).astype(np.float32)
        return g * np.float32(0.125), 0.125, 0.25, None, None
    if name == "one_per_voxel":
        g = np.stack(np.meshgrid(*(np.arange(14),) * 3, indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
        return g * np.float32(0.1) + np.float32(0.05), 0.1, 0.1, \
            np.zeros(3), None
    if name == "voxel_of_200":
        # 200 points in one voxel (numpy's pairwise sum above 128 values),
        # among sparse ones; its seed voxel holds them all too
        dense = (np.float32(1.3) + rng.uniform(0.0, 0.04, size=(200, 3))
                 ).astype(np.float32)
        pts = np.concatenate([cloud, dense])[rng.permutation(3200)]
        return pts, 0.05, 0.05, None, None
    if name == "d2c_ties":
        # copies and mirror images about each centre: equal distances
        base = rng.uniform(0.0, 2.0, size=(400, 3)).astype(np.float32)
        ctr = (np.floor(base / 0.5) + 0.5) * 0.5
        mirror = (2.0 * ctr - base).astype(np.float32)
        pts = np.concatenate([base, base, mirror])
        return pts[rng.permutation(len(pts))], 0.5, 0.5, \
            np.zeros(3), None
    if name == "mask":
        return cloud, 0.05, 0.2, None, rng.uniform(size=3000) < 0.6
    if name == "origin":
        mn = cloud.astype(np.float64).min(axis=0)
        return cloud, 0.05, 0.2, _grid_lattice_offsets(
            mn, 0.2, rng.uniform(0.0, 1.0, size=3)), None
    if name == "origin_mask":
        mask = rng.uniform(size=3000) < 0.9
        mn = cloud[mask].astype(np.float64).min(axis=0)
        return cloud, 0.05, 0.2, _grid_lattice_offsets(
            mn, 0.2, rng.uniform(0.0, 1.0, size=3)), mask
    raise KeyError(name)


CASES = ("negative", "on_faces", "one_per_voxel", "voxel_of_200",
         "d2c_ties", "mask", "origin", "origin_mask")


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_host(case):
    """The plain version (the CPU path) equals the JAX package's
    functions bit for bit."""
    pts, leaf, res, origin, mask = _case(case, np.random.default_rng(11))
    down, seeds = _assert_same(pts, leaf, res, origin, mask)
    if case == "one_per_voxel":
        assert len(down) == len(pts) and len(seeds) == len(pts)
    if case == "voxel_of_200":
        assert len(down) < len(pts) - 199
    if case == "d2c_ties":
        assert len(seeds) < len(pts) // 3


def test_plain_empty_cloud():
    """An empty cloud: no centroid on either side; no seed, and both
    seed choices raise (an all-false mask likewise)."""
    j_voxel_downsample, j_propagate_seeds = _jax_refs()
    pts = np.zeros((0, 3), np.float32)
    got = voxel_centroids(torch.from_numpy(pts), 0.1)
    assert got.shape == (0, 3)
    assert j_voxel_downsample(pts, 0.1).shape == (0, 3)
    with pytest.raises(ValueError):
        j_propagate_seeds(pts, 0.1)
    with pytest.raises(ValueError):
        voxel_seeds(torch.from_numpy(pts), 0.1)
    with pytest.raises(ValueError):
        voxel_seeds(torch.ones((5, 3)), 0.1,
                    mask=torch.zeros(5, dtype=torch.bool))


def test_plain_rejects_bad_operands():
    """Another dtype, shape or voxel size raises on every device."""
    with pytest.raises(ValueError, match="float32"):
        voxel_centroids(torch.ones((4, 3), dtype=torch.float64), 0.1)
    with pytest.raises(ValueError, match="float32"):
        voxel_seeds(torch.ones((4, 2)), 0.1)
    with pytest.raises(ValueError, match="mask"):
        voxel_seeds(torch.ones((4, 3)), 0.1, mask=torch.ones(4))
    with pytest.raises(ValueError, match="> 0"):
        voxel_centroids(torch.ones((4, 3)), 0.0)


# ---------------------------------------------------------------------------
# the inputs of the card's tests: the benchmark cells' shapes
# ---------------------------------------------------------------------------


def _synthetic_epoch(seed):
    """One synthetic epoch of the pair cells: 418 x 418 points."""
    return terrain_cloud(np.random.default_rng(seed), n_side=418)


@functools.lru_cache(maxsize=1)
def _rockfall_face():
    """The first epoch of the rockfall series of scene seed 7 at the
    reference's scale (150 x 100 m, 0.3 m spacing, 5 mm range noise)."""
    with tempfile.TemporaryDirectory() as tmp:
        scans = generate_rockfall(tmp, 1, seed=7)
        return read_pcd(os.path.join(scans, sorted(os.listdir(scans))[0]))


def _cell_inputs(cell):
    """(raw cloud, leaf, seed size, segmentation grid's points, seed
    origins, mask) of one card test: the raw cloud is downsampled, the
    grid's points are seeded at each origin under the mask.  ``masked`` is
    the unified path's call: the SOR-kept points of the centred,
    cell-sorted synthetic cloud, with the removed points masked."""
    if cell == "masked":
        raw, leaf, sv = _synthetic_epoch(2**32 + 3), 0.005, 0.05
        down = voxel_downsample(raw, leaf)
        shift0 = -down.astype(np.float64).mean(axis=0)
        pts_c = (down.astype(np.float64) + shift0).astype(np.float32)
        grid_pts = build_grid(pts_c, _seg_h(45, leaf)).points[:len(down)]
        keep = np.random.default_rng(5).uniform(size=len(down)) > 0.03
        mn = down.astype(np.float64).min(axis=0)
        return raw, leaf, sv, grid_pts, (
            None, np.floor(mn / sv) * sv + shift0), keep
    if cell == "synthetic":
        raw, leaf, sv = _synthetic_epoch(2**31 + 17), 0.005, 0.05
    else:
        raw, leaf, sv = _rockfall_face(), 0.3, 3.0
    down = voxel_downsample(raw, leaf)
    grid_pts = build_grid(down, _seg_h(45, leaf)).points[:len(down)]
    mn = grid_pts.astype(np.float64).min(axis=0)
    return raw, leaf, sv, grid_pts, (
        None, np.floor(mn / sv) * sv,
        _grid_lattice_offsets(mn, sv, [0.37, 1.9, 0.05])), None


@pytest.mark.parametrize("cell", ["synthetic", "rockfall", "masked"])
def test_host_versions_match_jax_at_the_cells_shapes(cell):
    """The port's host ``voxel_downsample`` and ``propagate_seeds``, the
    references of the card's tests, equal the JAX package's functions bit
    for bit on those tests' inputs."""
    j_voxel_downsample, j_propagate_seeds = _jax_refs()
    raw, leaf, sv, grid_pts, origins, mask = _cell_inputs(cell)
    down = voxel_downsample(raw, leaf)
    assert down.tobytes() == j_voxel_downsample(raw, leaf).tobytes()
    assert len(down) > 90_000
    for origin in origins:
        np.testing.assert_array_equal(
            _masked_seeds(propagate_seeds, grid_pts, sv, origin, mask),
            _masked_seeds(j_propagate_seeds, grid_pts, sv, origin, mask))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["synthetic", "rockfall"])
def test_k7_at_the_cells_shapes(cuda, cell):
    """One epoch of each configuration: the downsample of the raw cloud,
    then the seed choice of the segmentation grid (world-aligned origin,
    as ``build_patches`` anchors it, and the guard's offsets), on the card
    and on the host, bit for bit; each K7 entry launched once a call and
    each call counted in its span."""
    raw, leaf, sv, grid_pts, origins, _ = _cell_inputs(cell)
    n0 = dict(_cuda.LAUNCHES)
    plain0 = sum(_cuda.PLAIN_ON_CUDA.values())
    with gphase("prep.voxel"):
        got = voxel_centroids(torch.from_numpy(raw).to(cuda), leaf)
    down = voxel_downsample(raw, leaf)
    assert got.cpu().numpy().tobytes() == down.tobytes()
    assert len(down) > 90_000
    for origin in origins:
        t = torch.from_numpy(grid_pts).to(cuda)
        with gphase("seg.fused.seeds"):
            got = voxel_seeds(t, sv, origin=origin).cpu().numpy()
        np.testing.assert_array_equal(
            got, _masked_seeds(propagate_seeds, grid_pts, sv, origin))
        assert len(got) > 1000
    assert _cuda.LAUNCHES["voxel_keys"] == n0.get("voxel_keys", 0) + 4
    assert _cuda.LAUNCHES["voxel_segments"] == n0.get("voxel_segments", 0) + 4
    assert sum(_cuda.PLAIN_ON_CUDA.values()) == plain0
    counts = {}
    for r in list(GLOBAL_TIMER.records)[-4:]:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    assert counts["voxel_device"] == 1 and counts["seeds_device"] == 3


@pytest.mark.cuda
def test_k7_masked_seeds(cuda):
    """The unified path's call: the seeds of the SOR-kept points of the
    centred, cell-sorted synthetic cloud, over the whole grid with the
    removed points masked, against ``propagate_seeds`` of the kept points
    gathered back."""
    _raw, leaf, sv, grid_pts, origins, keep = _cell_inputs("masked")
    for so in origins:
        _assert_same(grid_pts, leaf, sv, so, keep, device=cuda)


@pytest.mark.cuda
def test_k7_wrapper_rejects_bad_operands(cuda):
    """A CUDA operand of another dtype, on another device, or not
    contiguous raises; nothing falls back to the plain version."""
    pts = torch.rand((1000, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        voxel_centroids(pts.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        voxel_centroids(torch.rand((3, 1000), device=cuda).t(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        voxel_seeds(torch.rand((3, 1000), device=cuda).t(), 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        voxel_seeds(pts, 0.1, mask=torch.ones(1000, dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        voxel_seeds(pts, 0.1, mask=torch.ones(1000, device=cuda))
