"""PyTorch port, each hand-written CUDA kernel against its plain PyTorch
version on the card.  A CUDA kernel has no CPU mode, so these tests skip
where no CUDA device is visible; ``python3 chip_smoke.py`` runs the same
comparisons at the main path's full size on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from piecewise_icp_torch.models.segmentation_device import (
    _seg_h, propagate_seeds)
from piecewise_icp_torch.ops import _cuda, nn_cuda, seg_cuda
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.utils.synth import terrain_cloud

pytestmark = pytest.mark.cuda

RES = 2.0 / 150


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def grid(cuda):
    rng = np.random.default_rng(3)
    pts = terrain_cloud(rng, n_side=150).astype(np.float64)
    pts = (pts - pts.mean(axis=0)).astype(np.float32)
    return CellGrid.from_index(build_grid(pts, _seg_h(45, RES)), cuda)


def _fresh(g):
    return dataclasses.replace(g, _self_nbr=[])


def _assert_range_nn1_equal(q, qm, grid):
    """K1 against its plain version, tolerance 0 (no FMA on either side):
    flags and count everywhere, ids and distances of the resolved queries
    (masked ones included: (0, inf)); an unresolved query's window does not
    hold its true nearest.  Two launches give the same count.  Returns
    (resolved flags, count)."""
    n0 = _cuda.LAUNCHES["range_nn1"]
    ki, kd, kr, _, kn = nn_cuda.range_nn1_counted(q, qm, grid)
    assert _cuda.LAUNCHES["range_nn1"] == n0 + 1
    pi, pd, pr, pn = nn_cuda.range_nn1_plain(q, qm, grid)
    assert ki.dtype == torch.int64 and kr.dtype == torch.bool
    assert bool((kr == pr).all())
    assert bool((ki[kr] == pi[kr]).all())
    assert bool((kd[kr] == pd[kr]).all())
    assert bool((ki >= 0).all())
    assert int(kn) == int(pn) == int((~kr).sum())
    again = nn_cuda.range_nn1_counted(q, qm, grid)
    assert int(again[4]) == int(kn)             # reset by every launch
    assert bool((again[1] == kd).all())
    return kr, int(kn)


def test_range_nn1(grid, cuda):
    rng = np.random.default_rng(4)
    q = grid.points + torch.from_numpy(
        rng.normal(scale=0.005, size=tuple(grid.points.shape)
                   ).astype(np.float32)).to(cuda)
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    kr, _ = _assert_range_nn1_equal(q, qm, grid)
    assert bool(kr.any())


@pytest.mark.parametrize("shape", ["stage1_masked", "planning", "sentinel",
                                   "under_one_block"])
def test_range_nn1_shapes(cuda, shape):
    """K1 at the shapes of the main path, scaled down: cell-coherent
    queries of which some are masked (the stage-1 percentile); a coarse
    grid, queries in no order, no mask, some outside the target's box
    (adaptive planning); queries at the 1e30 sentinel, masked and not; and
    fewer queries than one block serves."""
    rng = np.random.default_rng(8)
    pts = terrain_cloud(rng, n_side=150).astype(np.float64)
    pts = (pts - pts.mean(axis=0)).astype(np.float32)
    q = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    qm = np.ones(len(q), bool)
    h = 4.0 * RES
    if shape == "stage1_masked":
        qm = rng.uniform(size=len(q)) > 0.3
        q[rng.choice(len(q), 300, replace=False), 2] += 0.5   # unresolved
    elif shape == "planning":
        h = 10.0 * RES
        q = np.concatenate([q, rng.uniform(-3, 3, (500, 3)
                                           ).astype(np.float32)])
        q = q[rng.permutation(len(q))]
        qm = None
    elif shape == "sentinel":
        gone = rng.uniform(size=len(q)) < 0.05
        q[gone] = 1e30
        qm = ~gone
        qm[np.flatnonzero(gone)[:20]] = True     # live at the sentinel
    else:
        q, qm = q[:13], qm[:13]
    g = CellGrid.from_index(build_grid(pts, h), cuda)
    tq = torch.from_numpy(np.ascontiguousarray(q)).to(cuda)
    tqm = None if qm is None else torch.from_numpy(qm).to(cuda)
    kr, kn = _assert_range_nn1_equal(tq, tqm, g)
    assert bool(kr.any())
    if shape in ("stage1_masked", "planning"):
        assert kn > 0
    if shape == "sentinel":
        assert kn == 20                  # no window holds a finite distance


def test_range_nn1_no_query(grid, cuda):
    """No query: nothing is launched on the card's side of the entry, the
    outputs are empty and the count is 0."""
    i, d, r, _, n = nn_cuda.range_nn1_counted(
        torch.zeros((0, 3), device=cuda),
        torch.zeros(0, dtype=torch.bool, device=cuda), grid)
    assert i.shape == d.shape == r.shape == (0,) and int(n) == 0


def test_range_nn1_crowded_cell_and_sentinel(crowded):
    """A window far larger than any the terrain has (K1 stages and unrolls
    nothing by window size: one path), targets at the sentinel, masked
    queries."""
    g, qm, gone, h = crowded
    rng = np.random.default_rng(9)
    q = torch.where(gone[:, None], g.points, g.points + torch.from_numpy(
        rng.normal(scale=0.5 * h, size=tuple(g.points.shape)
                   ).astype(np.float32)).to(g.points.device))
    kr, kn = _assert_range_nn1_equal(q, qm, g)
    assert 0 < kn < int(qm.sum())
    assert bool(kr[gone].all())


def test_knn_sorted(grid, cuda):
    qm = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    ki, kd, kr = nn_cuda.knn_sorted(grid, qm, 15)
    pi, pd2 = nn_cuda.knn_sorted_plain(_fresh(grid), qm, 15)
    assert bool((ki[kr] == pi[kr]).all())
    assert bool((kd[kr] == torch.sqrt(pd2[kr])).all())


@pytest.fixture()
def crowded(cuda):
    """A grid with one cell crowded beyond the window a block stages in
    shared memory (the self-join kernels walk it from global memory) that
    also holds points moved to the sentinel, whose queries are masked.
    Returns (grid, query mask, sentinel mask, h)."""
    rng = np.random.default_rng(6)
    pts = terrain_cloud(rng, n_side=150).astype(np.float64)
    pts = (pts - pts.mean(axis=0)).astype(np.float32)
    h = _seg_h(45, RES)
    lib = _cuda.lib()
    cap = max(lib.pwicp_knn_cap(), lib.pwicp_seg_cap(), lib.pwicp_prop_cap())
    crowd = pts[len(pts) // 2] + rng.uniform(
        -0.2 * h, 0.2 * h, (cap + 100, 3)).astype(np.float32)
    # the crowd spans 0.4 h, so the window of each of its cells holds all
    # of it: more than the staged cap
    g = CellGrid.from_index(build_grid(np.concatenate([pts, crowd]), h), cuda)
    gone = torch.from_numpy(rng.uniform(size=g.n) < 0.01).to(cuda)
    g = g.with_points(torch.where(gone[:, None],
                                  torch.tensor(1e30, device=cuda), g.points))
    return g, ~gone, gone, h


def _propagation_inputs(g, qm, sv):
    """(normals, t2, seed indices) of the live points of ``g`` from K3."""
    t2, _, nrm = seg_cuda.seg_stats(g, qm, 45)
    live = np.flatnonzero(qm.cpu().numpy())
    seeds = live[propagate_seeds(g.points.cpu().numpy()[live], sv)]
    return nrm, t2, torch.from_numpy(seeds.astype(np.int64)).to(
        g.points.device)


def test_knn_sorted_crowded_cell_and_sentinel(crowded):
    """Both branches (staged window, walk from global memory) equal the
    plain version bit for bit."""
    g, qm, gone, h = crowded
    ki, kd, kr = nn_cuda.knn_sorted(g, qm, 15)
    pi, pd2 = nn_cuda.knn_sorted_plain(_fresh(g), qm, 15)
    pd = torch.sqrt(pd2)
    pr = ~qm | (pd[:, -1] <= float(np.float32(h)))
    assert bool((kr == pr).all())
    assert bool((ki[kr] == pi[kr]).all())
    assert bool((kd[kr] == pd[kr]).all())
    assert bool((ki[gone] == -1).all()) and bool(torch.isinf(kd[gone]).all())
    got = ki[qm]
    assert not bool((gone[got.clamp(min=0)] & (got >= 0)).any())


def _assert_stats_equal(ks, ps, h):
    assert bool((ks[:, :2] == ps[:, :2]).all())      # counts and t2 equal
    # moment sums in another order: 1e-5 of count * h (first moments)
    # and count * h^2 (second moments)
    scale = torch.cat([ps[:, :1].expand(-1, 3) * h,
                       ps[:, :1].expand(-1, 6) * h * h], dim=1)
    assert bool(((ks[:, 2:11] - ps[:, 2:11]).abs()
                 <= 1e-5 * scale + 1e-12).all())
    assert bool((ks[:, 11:] == 0).all())


def test_seg_stats(grid, cuda):
    qm = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    qm[::11] = False
    n0 = _cuda.LAUNCHES["seg_stats"]
    ks = seg_cuda.seg_stats_rows(grid, qm, 45)
    assert _cuda.LAUNCHES["seg_stats"] == n0 + 1
    ps = seg_cuda.seg_stats_plain(_fresh(grid), qm, 45)
    _assert_stats_equal(ks, ps, grid.h)
    again = seg_cuda.seg_stats_rows(grid, qm, 45)
    assert bool((ks == again).all())                 # the same bits each run


def test_seg_stats_crowded_cell_and_sentinel(crowded):
    """K3's staged and walked branches against the plain version; masked
    queries give the masked row."""
    g, qm, gone, h = crowded
    ks = seg_cuda.seg_stats_rows(g, qm, 45)
    ps = seg_cuda.seg_stats_plain(_fresh(g), qm, 45)
    _assert_stats_equal(ks, ps, h)
    assert bool((ks[gone, 0] == 0).all())
    assert bool((ks[gone, 1] == np.float32(h * h)).all())
    assert bool((ks[gone, 2:] == 0).all())


@pytest.mark.parametrize("adopt", [False, True])
def test_prop_round(grid, cuda, adopt):
    qm = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    t2, _, nrm = seg_cuda.seg_stats(grid, qm, 45)
    seeds = propagate_seeds(grid.points.cpu().numpy(), 10 * RES)
    state = seg_cuda.init_state(grid.points, nrm, torch.from_numpy(
        seeds.astype(np.int64)).to(cuda))
    qall = torch.cat([grid.points, nrm, t2[:, None],
                      torch.zeros_like(t2)[:, None]], dim=1).contiguous()
    args = (float(0.4 / (10 * RES)), grid.h * grid.h, adopt)
    for _ in range(2):
        state, _ = seg_cuda.prop_round(grid, qall, qm, state, *args[:2],
                                       False)
    ks, kc = seg_cuda.prop_round(grid, qall, qm, state, *args)
    ps, pc = seg_cuda.prop_round_plain(_fresh(grid), qall, qm, state, *args)
    assert bool((ks == ps).all())
    assert int(kc) == int(pc)


@pytest.mark.parametrize("adopt", [False, True])
def test_prop_round_crowded_cell_and_sentinel(crowded, adopt):
    """K4's staged and walked branches against the plain version."""
    g, qm, gone, h = crowded
    sv = 10 * RES
    nrm, t2, seed_idx = _propagation_inputs(g, qm, sv)
    state = seg_cuda.init_state(g.points, nrm, seed_idx)
    qall = torch.cat([g.points, nrm, t2[:, None],
                      torch.zeros_like(t2)[:, None]], dim=1).contiguous()
    args = (float(0.4 / sv), h * h)
    state, _ = seg_cuda.prop_round(g, qall, qm, state, *args, False)
    ks, kc = seg_cuda.prop_round(g, qall, qm, state, *args, adopt)
    ps, pc = seg_cuda.prop_round_plain(_fresh(g), qall, qm, state, *args,
                                       adopt)
    assert bool((ks == ps).all())
    assert int(kc) == int(pc)


@pytest.mark.parametrize("max_rounds", [256, 2, 0])
@pytest.mark.parametrize("which", ["terrain", "crowded"])
def test_propagate_rounds_whole_loop(request, which, max_rounds):
    """The whole loop in one launch against the host loop over the plain
    round: labels and round count equal, also where the cap ends the loop
    before convergence."""
    if which == "terrain":
        g = request.getfixturevalue("grid")
        qm = torch.ones(g.n, dtype=torch.bool, device=g.points.device)
    else:
        g, qm, _, _ = request.getfixturevalue("crowded")
    sv = 10 * RES
    nrm, t2, seed_idx = _propagation_inputs(g, qm, sv)
    before = dict(_cuda.LAUNCHES)
    kl, kr = seg_cuda.propagate_rounds(g, nrm, t2, qm, seed_idx, sv,
                                       max_rounds=max_rounds)
    assert _cuda.LAUNCHES["propagate"] == before.get("propagate", 0) + 1
    assert _cuda.LAUNCHES["prop_round"] == before.get("prop_round", 0) + 1
    pl, pr = seg_cuda.propagate_rounds_plain(_fresh(g), nrm, t2, qm,
                                             seed_idx, sv,
                                             max_rounds=max_rounds)
    assert kr == pr
    assert bool((kl == pl).all())
    if max_rounds == 256:
        assert 2 < kr < 256 and float((kl[qm] >= 0).float().mean()) > 0.99


@pytest.mark.parametrize("masked", [False, True])
def test_nn1_brute(cuda, masked):
    rng = np.random.default_rng(5)
    t = terrain_cloud(rng, n_side=100)
    t[-40:] = t[:40]                                 # exact ties
    q = terrain_cloud(rng, n_side=90)
    tt, qq = torch.from_numpy(t).to(cuda), torch.from_numpy(q).to(cuda)
    tm = qm = None
    if masked:
        tm = torch.from_numpy(rng.uniform(size=len(t)) > 0.01).to(cuda)
        qm = torch.from_numpy(rng.uniform(size=len(q)) > 0.4).to(cuda)
    n0 = _cuda.LAUNCHES["nn1_brute"]
    ki, kd2 = nn_cuda._nn1_brute_kernel(qq, tt, qm, tm)
    assert _cuda.LAUNCHES["nn1_brute"] == n0 + 1
    pi, pd2 = nn_cuda.nn1_brute_plain(qq, tt, qm, tm)
    # no FMA on either side: equal ids and squared distances, bit for bit
    assert bool((ki == pi).all())
    assert bool((kd2 == pd2).all())
    none = torch.zeros(len(t), dtype=torch.bool, device=cuda)
    ki, kd2 = nn_cuda._nn1_brute_kernel(qq, tt, None, none)
    assert bool((ki == -1).all()) and bool(torch.isinf(kd2).all())


@pytest.mark.parametrize("shape", ["table", "rescue", "all_masked",
                                   "under_one_block"])
def test_nn1_brute_shapes(cuda, shape):
    """K5 at the shapes of the main path, scaled down: masked queries and
    targets with duplicates (auto DT-init), a gathered unmasked subset
    against targets of which some sit at the sentinel (the stage-1 rescue),
    no live query, and fewer queries than one block."""
    rng = np.random.default_rng(7)
    t = terrain_cloud(rng, n_side=120)
    t[-60:] = t[:60]                                 # exact ties
    q = terrain_cloud(rng, n_side=110)
    tm = qm = None
    if shape == "table":
        tm = rng.uniform(size=len(t)) > 0.01
        qm = rng.uniform(size=len(q)) > 0.4
    elif shape == "rescue":
        q = q[np.sort(rng.choice(len(q), 4096, replace=False))]
        t[rng.choice(len(t) - 60, 200, replace=False)] = 1e30
    elif shape == "all_masked":
        qm = np.zeros(len(q), bool)
    else:
        q = q[:100]
        tm = rng.uniform(size=len(t)) > 0.01
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in (q, t, qm, tm)]
    n0 = _cuda.LAUNCHES["nn1_brute"]
    ki, kd2 = nn_cuda._nn1_brute_kernel(*args)
    assert _cuda.LAUNCHES["nn1_brute"] == n0 + 1
    pi, pd2 = nn_cuda.nn1_brute_plain(*args)
    assert bool((ki == pi).all())
    assert bool((kd2 == pd2).all())
    if shape == "all_masked":
        assert bool((ki == -1).all()) and bool(torch.isinf(kd2).all())
    else:
        assert bool((args[1][ki[ki >= 0], 0] < 1e29).all())


def test_stage1_rescue_launches_k5(grid, cuda):
    """The stage-1 percentile of the core loop re-measures its unresolved
    queries through K5, never through a plain version."""
    from piecewise_icp_torch.models.piecewise_icp import _stage1_percentile

    moved = grid.points + torch.tensor([0.0, 0.0, 3.0 * grid.h], device=cuda)
    stable = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    _cuda.reset_counts()
    d75, exact, n_bad = _stage1_percentile(moved, stable, grid, 0.75)
    assert 0 < n_bad <= 49152 and bool(exact)
    assert _cuda.LAUNCHES["nn1_brute"] == 1
    assert _cuda.LAUNCHES["range_nn1"] == 1
    assert not _cuda.PLAIN_ON_CUDA
    _, d = nn_cuda.nn1_brute_plain(moved, grid.points)
    want = torch.sort(torch.sqrt(d)).values[int(np.float32(grid.n)
                                                * np.float32(0.75))]
    assert float(d75) == float(want)


def test_stage1_without_unresolved_skips_k5(grid, cuda):
    """The twin: K1 counts no unresolved query, so the stage-1 percentile
    launches nothing else (no K5, no plain version) and is exact."""
    from piecewise_icp_torch.models.piecewise_icp import _stage1_percentile

    moved = grid.points + torch.tensor([0.0, 0.0, 0.2 * grid.h], device=cuda)
    stable = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    stable[::5] = False
    _cuda.reset_counts()
    d75, exact, n_bad = _stage1_percentile(moved, stable, grid, 0.75)
    assert n_bad == 0 and bool(exact)
    assert _cuda.LAUNCHES["range_nn1"] == 1
    assert _cuda.LAUNCHES["nn1_brute"] == 0
    assert not _cuda.PLAIN_ON_CUDA
    _, d = nn_cuda.nn1_brute_plain(moved[stable], grid.points)
    want = torch.sort(torch.sqrt(d)).values[
        int(np.float32(int(stable.sum())) * np.float32(0.75))]
    assert float(d75) == float(want)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("nproc", [2, 3])
def test_range_nn1_and_nn1_brute_on_a_shard(grid, cuda, nproc):
    """K1 and K5 on one rank's shard of a point-sharded cloud (a view with
    a storage offset; the cloud padded with masked rows to a multiple of
    the ranks, so the last shard ends in padding) give the bits of a
    contiguous copy of the shard: flags, count, ids and distances."""
    from piecewise_icp_torch.parallel import ShardGroup

    rng = np.random.default_rng(11)
    n = grid.n - 1                      # a multiple of neither 2 nor 3
    q = grid.points[:n] + torch.from_numpy(
        rng.normal(scale=RES, size=(n, 3)).astype(np.float32)).to(cuda)
    live = torch.from_numpy(rng.uniform(size=n) < 0.8).to(cuda)
    _cuda.reset_counts()
    for rank in range(nproc):
        g = ShardGroup(rank, nproc, cuda, "gloo")
        qs, ms = g.shard(g.pad_rows(q)), g.shard(g.pad_rows(live, False))
        rows = qs.shape[0]
        assert qs.storage_offset() == 3 * rank * rows
        on_view = nn_cuda.range_nn1_counted(qs, ms, grid)
        on_copy = nn_cuda.range_nn1_counted(qs.clone(), ms.clone(), grid)
        for i in (0, 1, 2, 4):
            assert _same_bits(on_view[i], on_copy[i])
        for a, b in zip(nn_cuda.nn1_brute(qs, grid.points, q_mask=ms),
                        nn_cuda.nn1_brute(qs.clone(), grid.points,
                                          q_mask=ms.clone())):
            assert _same_bits(a, b)
    assert not _cuda.PLAIN_ON_CUDA


def test_wrapper_rejects_bad_operands(grid, cuda):
    qm = torch.ones(grid.n, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        nn_cuda.range_nn1(grid.points.double(), qm, grid)
    with pytest.raises(ValueError):
        nn_cuda.knn_sorted(grid, qm[:-1], 15)
    with pytest.raises(ValueError):
        nn_cuda.nn1_brute(grid.points, grid.points, t_mask=qm[:-1])
    with pytest.raises(ValueError):
        seg_cuda.seg_stats_rows(grid, qm[:-1], 45)
    t2, _, nrm = seg_cuda.seg_stats(grid, qm, 45)
    seeds = torch.arange(0, grid.n, 50, device=cuda)
    with pytest.raises(ValueError):
        seg_cuda.propagate_rounds(grid, nrm.double(), t2, qm, seeds, 0.1)
    with pytest.raises(ValueError):
        seg_cuda.propagate_rounds(grid, nrm, t2[:-1], qm, seeds, 0.1)
    with pytest.raises(ValueError):
        seg_cuda.propagate_rounds(grid, nrm, t2, qm, seeds.int(), 0.1)
    with pytest.raises(ValueError):
        seg_cuda.propagate_rounds(grid, nrm, t2, qm, seeds, 0.1,
                                  max_rounds=-1)


def test_segment_sums_same_bits_in_two_runs(cuda):
    """The patch statistics' float segment sums add in a fixed order: at
    the smoke epoch's size (142,884 points, ~2,300 patches) two runs give
    the same bits, and the sums agree with the CPU's."""
    from piecewise_icp_torch.ops import segment_ops as seg

    rng = np.random.default_rng(5)
    n, p = 142884, 2300
    pts = terrain_cloud(rng, n_side=378).astype(np.float32)
    ids = rng.integers(-1, p, size=n)
    x = torch.from_numpy(pts).to(cuda)
    i = torch.from_numpy(ids).to(cuda)
    runs = [(seg.segment_sum(x, i, p), seg.segment_cov3(x, i, p))
            for _ in range(2)]
    (s0, (c0, m0, n0)), (s1, (c1, m1, n1)) = runs
    assert bool((s0 == s1).all()) and bool((c0 == c1).all())
    assert bool((m0 == m1).all()) and bool((n0 == n1).all())
    s_cpu = seg.segment_sum(torch.from_numpy(pts), torch.from_numpy(ids), p)
    torch.testing.assert_close(s0.cpu(), s_cpu, rtol=1e-6, atol=1e-4)


def test_patch_set_and_pair_same_bits_in_two_runs(cuda):
    """A PatchSet of the unified path and a whole registration, twice on
    the card: every field and the transform and VCM bit for bit."""
    from piecewise_icp_torch.config import PiecewiseICPConfig
    from piecewise_icp_torch.models.pairwise import register_pair
    from piecewise_icp_torch.models.segmentation_device import \
        preprocess_segment_device
    from piecewise_icp_torch.ops.preprocess import voxel_downsample
    from piecewise_icp_torch.utils.synth import make_pair

    c1, c2, _ = make_pair(np.random.default_rng(0),
                          [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005],
                          n_side=200, extent=1.0)
    cfg = PiecewiseICPConfig()
    down = voxel_downsample(c1, cfg.res1)
    sets = [preprocess_segment_device(
        down, cfg.res1, cfg.sor_neighbors, cfg.sor_std_mult_pair,
        cfg.svsize1, cfg.knn_normals, cfg, device=cuda)[0].to_numpy()
        for _ in range(2)]
    for f, v in sets[0].items():
        assert v.tobytes() == sets[1][f].tobytes(), f
    a, b = (register_pair(c1, c2, cfg, device=cuda) for _ in range(2))
    assert a.trans_mat.tobytes() == b.trans_mat.tobytes()
    assert a.vcm.tobytes() == b.vcm.tobytes()


def _knn_inputs(rng, nq, tied):
    """Targets on a lattice of exact ties (and 40 exact duplicates), or a
    terrain scan; a mask; queries drawn from the targets (self at distance
    0), half of them jittered; then 200 targets moved to the 1e30
    sentinel."""
    if tied:
        t = np.stack(np.meshgrid(np.arange(40), np.arange(40), np.arange(12),
                                 indexing="ij"), -1).reshape(-1, 3)
        t = (0.05 * t).astype(np.float32)
    else:
        t = terrain_cloud(rng, n_side=140)
    t[-40:] = t[:40]
    tm = rng.uniform(size=len(t)) > 0.05
    jitter = rng.normal(scale=0.02, size=(nq, 3)) * (
        rng.uniform(size=(nq, 1)) < 0.5)
    q = (t[rng.choice(len(t), nq)] + jitter).astype(np.float32)
    t[rng.choice(len(t) - 40, 200, replace=False)] = 1e30
    return q, t, tm


@pytest.mark.parametrize("k", [2, 15, 16, 32])
@pytest.mark.parametrize("nq,tied,masked", [(1, True, False),
                                            (100, True, True),
                                            (4096, False, True),
                                            (50000, True, False)])
def test_knn_brute(cuda, k, nq, tied, masked):
    """K6 against its plain version at tolerance 0 (no FMA on either side,
    correctly rounded sqrt and division): the K squared distances, their
    square roots and the SOR means, from 1 query to 50,000, on exact ties,
    duplicates, sentinel targets and masks; one launch a call."""
    rng = np.random.default_rng(nq + k)
    q, t, tm = _knn_inputs(rng, nq, tied)
    qq, tt = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    mm = torch.from_numpy(tm).to(cuda) if masked else None
    for epilogue in ("d2", "dist", "sor_mean"):
        n0 = _cuda.LAUNCHES["knn_brute"]
        got = nn_cuda.knn_brute(qq, tt, k, mm, epilogue)
        assert _cuda.LAUNCHES["knn_brute"] == n0 + 1
        want = nn_cuda.knn_brute_plain(qq, tt, k, mm, epilogue)
        assert got.shape == want.shape
        assert _same_bits(got, want), epilogue
    d2 = nn_cuda.knn_brute(qq, tt, k, mm)
    assert bool((d2 < 1e30).all())         # no sentinel target met


def _bound_inputs(rng, case):
    """~130k targets and 300 queries (too few to fill the card a warp a
    query: 8 warps split the targets of each query and share its bound).
    ``lattice_ties``: a 51 x 51 x 50 integer lattice (exact squared
    distances), queries on lattice points and at cell centres, so the K-th
    distance is tied among shells of 6 to 24 points that the strided
    layout spreads over different slices, with 300 targets doubled.  ``duplicates_masked``: a terrain scan with 2,000
    targets doubled, 5% masked, 200 at the 1e30 sentinel; queries from the
    targets, half jittered.  ``all_masked``: the same with every target
    masked."""
    if case == "lattice_ties":
        t = np.stack(np.meshgrid(np.arange(51), np.arange(51), np.arange(50),
                                 indexing="ij"), -1).reshape(-1, 3)
        t = t.astype(np.float32)
        t[rng.choice(len(t), 300, replace=False)] = t[:300]
        q = t[rng.choice(len(t), 300, replace=False)].copy()
        q[::2] += 0.5
        return q, t, None
    t = terrain_cloud(rng, n_side=361)
    t[-2000:] = t[:2000]
    q = t[rng.choice(len(t), 300, replace=False)] + (
        rng.normal(scale=0.02, size=(300, 3))
        * (rng.uniform(size=(300, 1)) < 0.5)).astype(np.float32)
    t[rng.choice(len(t) - 2000, 200, replace=False)] = 1e30
    tm = rng.uniform(size=len(t)) > 0.05
    if case == "all_masked":
        tm[:] = False
    return q.astype(np.float32), t, tm


@pytest.mark.parametrize("k", [1, 14, 15, 16, 32])
@pytest.mark.parametrize("case", ["lattice_ties", "duplicates_masked",
                                  "all_masked"])
def test_knn_brute_shared_bound(cuda, k, case):
    """K6 with the targets of each query split over 8 warps that share its
    pruning bound (the layout the library launches at this shape), against
    its plain version at tolerance 0 for every epilogue: ties at the K-th
    value across the warps' slices, duplicate targets, masks, and every
    target masked (the bound never leaves the sentinel: every slot +inf,
    SOR mean 0)."""
    rng = np.random.default_rng(k + 100 * len(case))
    q, t, tm = _bound_inputs(rng, case)
    assert nn_cuda.knn_brute_layout(len(q), len(t), k)["slices"] == 8
    qq, tt = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    mm = None if tm is None else torch.from_numpy(tm).to(cuda)
    for epilogue in ("d2", "dist", "sor_mean"):
        n0 = _cuda.LAUNCHES["knn_brute"]
        got = nn_cuda.knn_brute(qq, tt, k, mm, epilogue)
        assert _cuda.LAUNCHES["knn_brute"] == n0 + 1
        want = nn_cuda.knn_brute_plain(qq, tt, k, mm, epilogue)
        assert _same_bits(got, want), epilogue
    d2 = nn_cuda.knn_brute(qq, tt, k, mm)
    if case == "all_masked":
        assert bool(torch.isinf(d2).all())
    else:
        assert bool((d2 < 1e30).all())
    if case == "lattice_ties" and k < 32:
        # the K-th value is tied with the (K+1)-th: the cut falls in a tie
        nxt = nn_cuda.knn_brute_plain(qq, tt, k + 1, mm)
        assert bool((nxt[:, k] == nxt[:, k - 1]).any())


@pytest.mark.parametrize("shape", [
    # (queries, targets): queries a warp, warps sharing a query, blocks
    ((4096, 129097), (2, 2, 512)),      # bench_torch.py's rescue
    ((12159, 101271), (3, 1, 507)),     # the rockfall SOR rescue
    ((135314, 135314), (4, 1, 4229)),   # the no-grid SOR
    ((142884, 142884), (4, 1, 4466)),   # resolution estimation
    ((1, 129097), (2, 8, 1)),           # the smoke pair's rescue
    ((300, 130050), (2, 8, 150)),       # test_knn_brute_shared_bound
])
def test_knn_brute_layout_at_the_path_shapes(cuda, shape):
    """K6's layout, as the built library launches it, at the shapes of its
    paths, as ``PERF.md`` cites it: a warp takes 4 queries where that still
    gives 480 blocks of 8 warps (about a wave at 4 blocks on each of 132
    SMs), else 3, else 2, and below that the warps of a block split the
    tiles, 2, 4 or 8 warps holding one query's list; the scratch is the
    targets' structure of arrays, whole tiles of 1,024."""
    (nq, nt), want = shape
    lay = nn_cuda.knn_brute_layout(nq, nt, 15)
    assert (lay["qpw"], lay["slices"], lay["blocks"]) == want
    assert lay["warps"] == 8
    assert lay["blocks"] * lay["block_queries"] >= nq > (
        lay["blocks"] - 1) * lay["block_queries"]
    assert lay["block_queries"] * lay["slices"] == lay["qpw"] * lay["warps"]
    assert lay["slices"] == lay["warps"] or lay["blocks"] >= 480
    assert lay["n_tiles"] == -(-nt // 1024)
    assert (_cuda.lib().pwicp_knn_brute_cap(nq, nt, 15)
            == 3 * 1024 * lay["n_tiles"])


def test_knn_brute_few_targets_and_no_query(cuda):
    """Fewer valid targets than K (empty slots +inf), no target at all, and
    no query (no launch)."""
    rng = np.random.default_rng(2)
    q, t, _ = _knn_inputs(rng, 300, True)
    qq = torch.from_numpy(q).to(cuda)
    tt = torch.from_numpy(t[:10]).to(cuda)
    mm = torch.zeros(10, dtype=torch.bool, device=cuda)
    mm[:4] = True
    for targets, mask in ((tt, mm), (tt, None), (tt[:0], None)):
        for epilogue in ("d2", "sor_mean"):
            got = nn_cuda.knn_brute(qq, targets, 15, mask, epilogue)
            want = nn_cuda.knn_brute_plain(qq, targets, 15, mask, epilogue)
            assert _same_bits(got, want)
    assert bool(torch.isinf(nn_cuda.knn_brute(qq, tt, 15, mm)[:, 4:]).all())
    n0 = _cuda.LAUNCHES["knn_brute"]
    assert nn_cuda.knn_brute(qq[:0], tt, 15).shape == (0, 15)
    assert _cuda.LAUNCHES["knn_brute"] == n0
    with pytest.raises(ValueError):
        nn_cuda.knn_brute(qq, tt, 33)
    with pytest.raises(ValueError):
        nn_cuda.knn_brute(qq.double(), tt, 15)


def test_sor_and_resolution_launch_k6(cuda):
    """The brute SOR, resolution estimation and the staged SOR's rescue of
    every unresolved query run K6 on the card, never a plain version, and
    give the CPU's bits."""
    from piecewise_icp_torch.ops import preprocess as tpre

    rng = np.random.default_rng(9)
    pts = terrain_cloud(rng, n_side=80)
    z0 = float(pts[:, 2].max()) + 0.2
    sparse = np.stack([rng.uniform(0.0, 2.0, 600), rng.uniform(0.0, 2.0, 600),
                       z0 + rng.exponential(1.0, 600)], 1).astype(np.float32)
    down = tpre.voxel_downsample(np.concatenate([pts, sparse]), 0.02)
    _cuda.reset_counts()
    keep = tpre.sor_keep_mask_device(down, 0.02, 14, 2.7, cuda)
    brute = tpre.sor_filter_mask(torch.from_numpy(down).to(cuda), None, 14,
                                 2.7)
    res = tpre.estimate_resolution(torch.from_numpy(down).to(cuda))
    assert _cuda.LAUNCHES["knn_brute"] == 3
    assert not _cuda.PLAIN_ON_CUDA
    # the K6 results are the CPU's bits; the global sums that follow them
    # add in another order on the card
    cpu = torch.device("cpu")
    keep_cpu = tpre.sor_keep_mask_device(down, 0.02, 14, 2.7, cpu)
    brute_cpu = tpre.sor_filter_mask(torch.from_numpy(down), None, 14, 2.7)
    assert (keep == keep_cpu).mean() >= 0.999 and (~keep).sum() > 0
    assert (brute.cpu() == brute_cpu).float().mean() >= 0.999
    res_cpu = tpre.estimate_resolution(torch.from_numpy(down))
    assert abs(res - res_cpu) <= 1e-6 * res_cpu
