"""PyTorch port, several ranks on one pair: the staged loop point-sharded
over a ``torch.distributed`` process group (gloo ranks on the CPU, spawned
by ``parallel.launch``) held against the JAX package's mesh path
(``build_sharded_iteration``, ``piecewise_icp(mesh=...)`` on the
conftest's virtual CPU devices) and against the port's single device, on
the ``n_side=60`` scene of ``tests/test_parallel.py``; the entry points
and the CLI on two ranks; the guards against hangs and divergence.

Each scenario spawns its ranks once, in a module-scoped fixture that
several tests read, and every launch carries a timeout of its own (a hung
collective fails one test, not the run).  The functions that run in the
ranks are module-level and import nothing of JAX: the JAX package is
imported inside the fixtures that compute its references.
"""

import dataclasses
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from piecewise_icp_torch import piecewise_icp_pair_call
from piecewise_icp_torch.__main__ import main as cli_main
from piecewise_icp_torch.config import PiecewiseICPConfig
from piecewise_icp_torch.io import formats, write_pcd
from piecewise_icp_torch.models import piecewise_icp as core_mod
from piecewise_icp_torch.models.four_d import run_4d
from piecewise_icp_torch.models.segmentation import PatchSet
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.ops.transform import (apply_transform_np,
                                               matrix_to_angles,
                                               translation_matrix)
from piecewise_icp_torch.parallel import (ShardGroup, gather_rows,
                                          is_multiprocess, launch,
                                          make_group)
from piecewise_icp_torch.utils.errors import PwICPError
from piecewise_icp_torch.utils.logging import GLOBAL_TIMER
from piecewise_icp_torch.utils.synth import make_series, write_ground_truth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARC_TO_MGON = 1000.0 * 200.0 / np.pi
PARAMS = np.array([0.001, -0.001, 0.0015, 0.003, -0.004, 0.002])
# every spawn's limit (the launch, and a rank's wait in one collective)
SPAWN_S = 120.0
N_EPOCHS = 3
# the misaligned registration: the source raised beyond the stage-1 grid's
# h (0.088 m) under a larger DTinit, with a rescue budget small enough
# that every shard leaves unresolved queries, so the per-shard rescue and
# the exact percentile through the gather both run
MISALIGN_M, MIS_DT_INIT, MIS_BUDGET = 0.15, 0.25, 200


def _cfg(**over) -> PiecewiseICPConfig:
    """The port's twin of ``tests/util.py:small_test_config``."""
    kw = dict(set_res_svsize=True, res1=0.022, res2=0.022, svsize1=0.22,
              svsize2=0.22, set_dtinit=True, dt_init=0.05, dt_min=0.004)
    kw.update(over)
    return PiecewiseICPConfig(**kw)


# --------------------------------------------------------------------------
# what runs in the ranks (and, with group=None, in this process)
# --------------------------------------------------------------------------


def _step(cfg, p1: PatchSet, p2: PatchSet, group):
    """One ``_iteration_step`` on the patch sets' arrays, the source cloud
    in its own order; with a group, patch rows and cloud padded to a
    multiple of the ranks and the cloud sharded.  Returns the stats and
    the whole of every output (stable, pt_stable, moved cloud, ct2)."""
    dev = torch.device("cpu")

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if dtype is None else t.to(dtype)

    def rows(t, value=0):
        return t if group is None else group.pad_rows(t, value)

    def shard(t, value=0):
        return t if group is None else group.shard(rows(t, value))

    n_p1, n_p2, n = p1.num_patches, p2.num_patches, len(p2.points)
    grid = CellGrid.from_index(build_grid(p1.points, h=4.0 * cfg.res1), dev)
    out = core_mod._iteration_step(
        up(p1.centroids), up(p1.normals), up(p1.std_ct),
        torch.ones(n_p1, dtype=torch.bool),
        rows(up(p2.centroids)), rows(up(p2.normals)),
        rows(up(p2.boundary)).reshape(-1, 3), rows(up(p2.std_bp)),
        rows(torch.ones(n_p2, dtype=torch.bool), False),
        shard(up(p2.points)), shard(torch.ones(n, dtype=torch.bool), False),
        shard(up(p2.labels, torch.int64), -1), grid,
        cfg.dt_init, cfg.dt_min, cfg.dt_min * cfg.lod_max_ratio,
        cfg.svsize1 + cfg.svsize2, 2.0 * cfg.res2, cfg.dtinit_percentile,
        True, cfg, group=group)
    stats, stable, pt_stable, cloud2, ct2 = out[:5]
    return dict(stats=stats, stable=stable[:n_p2].numpy(),
                pt_stable=gather_rows(pt_stable, group)[:n].numpy(),
                cloud2=gather_rows(cloud2, group)[:n].numpy(),
                ct2=ct2[:n_p2].numpy())


def _register(cfg, c1, c2, p1, p2, group):
    GLOBAL_TIMER.records.clear()
    res = core_mod.piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg,
                                 patches1=p1, patches2=p2, device="cpu",
                                 group=group)
    rec = GLOBAL_TIMER.records
    return dict(trans_mat=res.trans_mat, vcm=res.vcm, dt=res.dt_series,
                iterations=res.iterations, stable=res.stable_point_mask,
                n_stable=res.final_n_stable,
                exact=sum(r["phase"] == "core.percentile_exact" for r in rec),
                rescued=[r["queries"] for r in rec
                         if r["phase"] == "core.stage1_rescue"])


def _misaligned(cfg, c1, c2, p1, p2, group):
    """The registration with the source raised and the rescue budget cut
    (see ``MISALIGN_M``)."""
    up = translation_matrix(np.array([0.0, 0.0, MISALIGN_M]))
    budget, core_mod._PCT_RESCUE = core_mod._PCT_RESCUE, MIS_BUDGET
    try:
        return _register(dataclasses.replace(cfg, dt_init=MIS_DT_INIT), c1,
                         apply_transform_np(c2, up).astype(np.float32), p1,
                         p2.transformed(up), group)
    finally:
        core_mod._PCT_RESCUE = budget


def _one_thread():
    """One intra-op thread a rank: the arrays are small, and spare threads
    would only spin while the other test workers need the cores."""
    torch.set_num_threads(1)


def _parity_rank(group, cfg, c1, c2, p1, p2):
    """One iteration and one whole registration on this rank (every
    rank's transform comes back through rank 0), the misaligned
    registration, then the replication check on its own."""
    _one_thread()
    step = _step(cfg, p1, p2, group)
    full = _register(cfg, c1, c2, p1, p2, group)
    full["every_rank"] = group.gather_object(full["trans_mat"])
    calls = dict(group.calls)
    mis = _misaligned(cfg, c1, c2, p1, p2, group)
    mis["every_rank"] = group.gather_object(mis["rescued"])
    default = make_group()
    return dict(step=step, full=full, calls=calls, mis=mis,
                replicated=_replicated(group),
                default=(is_multiprocess(), default.rank, default.size,
                         str(default.device), default.backend))


def _counting_writes():
    """Count, in this process, the calls of the writers of the report,
    the tables and the pair files."""
    calls = {}
    for mod, names in ((formats, ("write_trans_matrix_report",
                                  "write_trans_matrices",
                                  "write_abs_errors", "write_reg_pairs")),
                       (np, ("savez",))):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
    return calls


def _pair_call_rank(group, conf_pair, prefix):
    """``piecewise_icp_pair_call`` on this rank; every rank's count of file
    writes comes back through rank 0."""
    _one_thread()
    writes = _counting_writes()
    ok = piecewise_icp_pair_call(conf_pair, prefix, device="cpu",
                                 group=group, guard_enabled=False)
    return dict(ok=ok, writes=group.gather_object(writes))


def _campaign_rank(group, cfg_4d):
    """A campaign on this rank; every rank's count of file writes comes
    back through rank 0."""
    _one_thread()
    writes = _counting_writes()
    ok = run_4d(cfg_4d, 0, N_EPOCHS, -1, device="cpu", group=group)
    return dict(ok=ok, writes=group.gather_object(writes))


def _raising_rank(group):
    """Rank 1 raises at once; rank 0 waits in a barrier for it."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.barrier()


def _replicated(group):
    """``check_replicated`` on equal tensors, then on tensors whose last
    bit differs on the last rank; every rank's (raised on equal, raised on
    the flip) comes back through rank 0."""
    a = torch.linspace(0.0, 1.0, 301)
    b = torch.arange(17, dtype=torch.int32)

    def raised(*ts):
        try:
            group.check_replicated(*ts)
        except PwICPError:
            return True
        return False

    flipped = b.clone()
    if group.rank == group.size - 1:
        flipped[-1] ^= 1
    return group.gather_object((raised(a, b), raised(a, flipped)))


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    """The scene of ``tests/test_parallel.py``: the JAX package's patch
    sets (its native segmentation) carried into the port."""
    from piecewise_icp_tpu.models.segmentation import build_patches
    from util import make_pair, small_test_config

    rng = np.random.default_rng(7)
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=60)
    jcfg = small_test_config()
    ps1 = build_patches(c1, jcfg.svsize1, jcfg)
    ps2 = build_patches(c2, jcfg.svsize2, jcfg)
    return dict(jcfg=jcfg, cfg=_cfg(), c1=c1, c2=c2, t_true=t_true,
                jps=(ps1, ps2), ps=(PatchSet.from_numpy(ps1),
                                    PatchSet.from_numpy(ps2)))


@pytest.fixture(scope="module")
def single(scene):
    """The port's single device: one iteration, one registration."""
    p1, p2 = scene["ps"]
    args = (scene["cfg"], scene["c1"], scene["c2"], p1, p2, None)
    return dict(step=_step(scene["cfg"], p1, p2, None),
                full=_register(*args), mis=_misaligned(*args))


@pytest.fixture(scope="module")
def jax_mesh(scene):
    """The JAX package on a 2-device mesh: one sharded iteration
    (``build_sharded_iteration``) and ``piecewise_icp(mesh=...)``."""
    import jax.numpy as jnp
    from piecewise_icp_tpu.models.piecewise_icp import (_mask, _pad,
                                                        piecewise_icp)
    from piecewise_icp_tpu.ops.grid_nn import build_grid as j_build_grid
    from piecewise_icp_tpu.parallel.sharded import (build_sharded_iteration,
                                                    make_mesh,
                                                    point_sharded,
                                                    replicated)

    cfg, (ps1, ps2) = scene["jcfg"], scene["jps"]
    mesh = make_mesh(2)
    pm = int(np.lcm(cfg.patch_pad_multiple, 2))
    cm = int(np.lcm(cfg.point_pad_multiple, 2))
    grid = j_build_grid(ps1.points, h=max(4.0 * cfg.res1, 1e-6))
    sharded = dict(cloud2=_pad(ps2.points, cm),
                   cloud2_mask=_mask(len(ps2.points), cm),
                   labels2=_pad(ps2.labels, cm, value=-1))
    repl = [_pad(ps1.centroids, pm), _pad(ps1.normals, pm),
            _pad(ps1.std_ct, pm), _mask(ps1.num_patches, pm),
            _pad(ps2.centroids, pm), _pad(ps2.normals, pm),
            _pad(ps2.boundary.reshape(-1, 3), 6 * pm), _pad(ps2.std_bp, pm),
            _mask(ps2.num_patches, pm)]
    tail = [grid.points, grid.cell_starts, grid.origin,
            np.asarray(grid.dims, np.int32), np.asarray(grid.h, np.float32)]
    scalars = [np.float32(cfg.dt_init), np.float32(cfg.dt_min),
               np.float32(cfg.dt_min * cfg.lod_max_ratio),
               np.float32(cfg.svsize1 + cfg.svsize2),
               np.float32(2.0 * cfg.res2), np.float32(0.75),
               np.asarray(True)]
    step = build_sharded_iteration(mesh, grid_max_run=grid.max_run)
    out = step(*[replicated(mesh, jnp.asarray(v)) for v in repl],
               *[point_sharded(mesh, jnp.asarray(v))
                 for v in sharded.values()],
               *[replicated(mesh, jnp.asarray(v)) for v in tail],
               *[jnp.asarray(v) for v in scalars])
    n_p2, n = ps2.num_patches, len(ps2.points)
    j_step = dict(stats=np.asarray(out[0], np.float64),
                  stable=np.asarray(out[1])[:n_p2],
                  pt_stable=np.asarray(out[2])[:n],
                  cloud2=np.asarray(out[3])[:n],
                  ct2=np.asarray(out[4])[:n_p2])
    res = piecewise_icp(scene["c1"], scene["c2"], cfg.res1, cfg.res2, cfg,
                        patches1=ps1, patches2=ps2, mesh=mesh)
    return dict(step=j_step, full=dict(trans_mat=res.trans_mat, vcm=res.vcm,
                                       iterations=res.iterations))


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def ranks(request, scene):
    """One spawn of 2 (even rows) or 3 ranks (padding, uneven rows)."""
    p1, p2 = scene["ps"]
    t0 = time.perf_counter()
    out = launch(_parity_rank, request.param, scene["cfg"], scene["c1"],
                 scene["c2"], p1, p2, device="cpu", timeout=SPAWN_S)
    out["nproc"], out["seconds"] = request.param, time.perf_counter() - t0
    return out


def _check_step(got, want):
    """The tolerances of ``tests/test_parallel.py:94-108``."""
    s, w = got["stats"], want["stats"]
    np.testing.assert_allclose(s[:16], w[:16], atol=5e-5)     # transform
    assert s[16] == pytest.approx(w[16], rel=1e-6)             # lod_min
    assert int(s[17]) == int(w[17])                            # n_stable
    assert s[20] == pytest.approx(w[20], rel=1e-4)             # d75
    assert bool(s[21]) and bool(w[21])                         # exact
    np.testing.assert_array_equal(got["stable"], want["stable"])
    np.testing.assert_allclose(got["cloud2"], want["cloud2"], atol=1e-5)
    np.testing.assert_allclose(got["ct2"], want["ct2"], atol=1e-5)


def _check_full(got, want, same_iterations=True):
    """``tests/test_parallel.py:122-138``: same iterations, within 0.5
    mgon and 0.05 mm, the VCM within rtol 5e-2."""
    if same_iterations:
        assert got["iterations"] == want["iterations"]
    d_ang = (np.array(matrix_to_angles(got["trans_mat"]))
             - np.array(matrix_to_angles(want["trans_mat"])))
    d_t = got["trans_mat"][:3, 3] - want["trans_mat"][:3, 3]
    assert np.abs(d_ang * ARC_TO_MGON).max() < 0.5
    assert np.abs(d_t * 1000).max() < 0.05
    np.testing.assert_allclose(got["vcm"], want["vcm"], rtol=5e-2,
                               atol=1e-14)


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------


def test_iteration_matches_single_device(ranks, single):
    _check_step(ranks["step"], single["step"])
    np.testing.assert_array_equal(ranks["step"]["pt_stable"],
                                  single["step"]["pt_stable"])


def test_iteration_matches_jax_mesh(ranks, jax_mesh):
    _check_step(ranks["step"], jax_mesh["step"])


def test_registration_matches_single_device(ranks, single):
    _check_full(ranks["full"], single["full"])
    assert (ranks["full"]["stable"] == single["full"]["stable"]).mean() \
        > 0.999


def test_registration_matches_jax_mesh(ranks, jax_mesh):
    _check_full(ranks["full"], jax_mesh["full"])


def test_rescue_per_shard_and_exact_percentile_through_the_gather(ranks,
                                                                  single):
    """With the source raised and the budget cut, every shard rescues its
    own unresolved queries up to the budget (its count differs by rank, so
    the collectives sit after the branch on it), the exact percentile runs
    on the gathered cloud and gives the single device's DT, and the result
    is the single device's.  The number of outer iterations is not held:
    the first iteration removes the whole offset, and from there the
    stage-2 decay divides box changes of ~1e-8 m (float32 noise of the
    solve), so the schedule's length follows the summation order."""
    got, want = ranks["mis"], single["mis"]
    assert want["exact"] > 0 and got["exact"] > 0
    for rescued in got["every_rank"]:
        assert rescued and max(rescued) == MIS_BUDGET
    np.testing.assert_allclose(got["dt"][:2], want["dt"][:2], rtol=1e-5)
    _check_full(got, want, same_iterations=False)


def test_ranks_bit_equal_and_truth_bound(ranks, scene):
    """Every rank's transform has the same bits; the registration meets
    the truth bound of ``tests/test_parallel.py:127-136``."""
    first, *rest = ranks["full"]["every_rank"]
    assert len(rest) == ranks["nproc"] - 1
    for t in rest:
        assert t.tobytes() == first.tobytes()
    c2 = scene["c2"].astype(np.float64)
    m = ranks["full"]["trans_mat"] @ scene["t_true"]
    disp = np.linalg.norm(apply_transform_np(c2, m) - c2, axis=1)
    assert disp.mean() < 5e-3


def test_collectives_of_a_registration(ranks):
    """What crossed the ranks: the inner ICP's packed sums, the box's min
    and max, the stage-1 gather and counts, the stable-point sum and one
    replication check a registration (the iteration ran outside one)."""
    calls = ranks["calls"]
    assert calls["check_replicated"] == 1
    assert calls["min"] == calls["max"] == calls["sum"] > 0
    assert calls["sum_many"] > calls["sum"]
    assert calls["gather"] >= 2            # stage-1 distances, final mask
    assert ranks["seconds"] < SPAWN_S


# --------------------------------------------------------------------------
# entry points and CLI
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A pair (``make_pair``, n_side 60) and a 3-epoch series written as
    PCD files, with the pair's configuration."""
    from piecewise_icp_torch.utils.synth import make_pair

    root = tmp_path_factory.mktemp("entry")
    c1, c2, t_true = make_pair(np.random.default_rng(7), PARAMS, n_side=60)
    write_pcd(root / "Epoch_000.pcd", c1)
    write_pcd(root / "Epoch_001.pcd", c2)
    conf = root / "config_pair.txt"
    _cfg(path1=str(root / "Epoch_000.pcd"),
         path2=str(root / "Epoch_001.pcd")).to_reference_file(conf)
    scans = root / "scans"
    scans.mkdir()
    epochs, gt = make_series(np.random.default_rng(42), N_EPOCHS, n_side=60)
    for k, e in enumerate(epochs):
        write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
    write_ground_truth(root / "defined_transformations.txt", gt)
    return dict(root=root, conf=conf, scans=scans, t_true=t_true, c2=c2)


@pytest.fixture(scope="module")
def pair_entry(files):
    """The pair call on one process and on 2 ranks (one spawn)."""
    one, two = files["root"] / "one", files["root"] / "two"
    assert piecewise_icp_pair_call(str(files["conf"]), str(one) + "_",
                                   device="cpu", guard_enabled=False)
    out = launch(_pair_call_rank, 2, str(files["conf"]), str(two) + "_",
                 device="cpu", timeout=SPAWN_S)
    return dict(one=one, two=two, out=out)


@pytest.fixture(scope="module")
def campaign_entry(files):
    """The campaign on one process and on 2 ranks (one spawn)."""
    def cfg_4d(out):
        return _cfg(path1=str(files["scans"]), path2=str(out) + os.sep,
                    set_dtinit=False, kalman_enabled=True,
                    kalman_process_noise=1e-6, guard_enabled=False)

    one, two = files["root"] / "c_one", files["root"] / "c_two"
    assert run_4d(cfg_4d(one), 0, N_EPOCHS, -1, device="cpu")
    out = launch(_campaign_rank, 2, cfg_4d(two), device="cpu",
                 timeout=SPAWN_S)
    return dict(one=one, two=two, out=out)


def _angles_mm(t):
    return (np.array(matrix_to_angles(t)) * ARC_TO_MGON, t[:3, 3] * 1e3)


def test_pair_call_writes_its_report_once(pair_entry):
    """The 2-rank pair call returns True on rank 0, which alone writes the
    report."""
    assert pair_entry["out"]["ok"]
    assert pair_entry["out"]["writes"] == [{"write_trans_matrix_report": 1},
                                           {}]


def test_pair_call_on_two_ranks(pair_entry, files):
    """The report of the 2-rank pair call is the 1-process report within
    0.5 mgon / 0.05 mm and the VCM within rtol 5e-2, and meets the truth
    bounds."""
    one = formats.read_trans_matrix_report(str(pair_entry["one"])
                                           + "_TransMatrix.txt")
    two = formats.read_trans_matrix_report(str(pair_entry["two"])
                                           + "_TransMatrix.txt")
    (a1, t1), (a2, t2) = _angles_mm(one["trans_mat"]), \
        _angles_mm(two["trans_mat"])
    assert np.abs(a1 - a2).max() < 0.5 and np.abs(t1 - t2).max() < 0.05
    np.testing.assert_allclose(two["vcm"], one["vcm"], rtol=5e-2,
                               atol=1e-14)
    c2 = files["c2"].astype(np.float64)
    disp = np.linalg.norm(apply_transform_np(
        c2, two["trans_mat"] @ files["t_true"]) - c2, axis=1)
    assert disp.mean() < 2e-3 and disp.max() < 5e-3


def test_campaign_writes_every_table_once(campaign_entry):
    """The 2-rank campaign returns True on rank 0, which alone writes every
    table, each once."""
    entry = campaign_entry
    assert entry["out"]["ok"]
    root0, rest = entry["out"]["writes"][0], entry["out"]["writes"][1:]
    assert all(not w for w in rest)
    # one report a pair; three matrix tables; raw and smoothed errors; the
    # plan; one pair file a pair
    assert root0["write_trans_matrix_report"] == N_EPOCHS - 1
    assert root0["write_trans_matrices"] == 3
    assert root0["write_abs_errors"] == 2
    assert root0["write_reg_pairs"] == 1
    assert root0["savez"] == N_EPOCHS - 1
    for name in ("TransParameters_toRef.txt", "phase_timings.jsonl",
                 "TransMatrices_toRef_smoothed.txt"):
        assert (entry["two"] / name).exists(), name


def test_campaign_on_two_ranks(campaign_entry):
    """The chained errors of the 2-rank campaign are those of the 1-process
    campaign within 0.5 mgon / 0.05 mm."""
    entry = campaign_entry
    e1 = formats.read_abs_errors(entry["one"] / "TransPara_AbsError.txt")
    e2 = formats.read_abs_errors(entry["two"] / "TransPara_AbsError.txt")
    assert e1.shape == e2.shape == (N_EPOCHS - 1, 6)
    assert np.abs(e1[:, :3] - e2[:, :3]).max() < 0.5
    assert np.abs(e1[:, 3:] - e2[:, 3:]).max() < 0.05


def test_cli_mesh_devices_on_cpu(files, tmp_path):
    # one intra-op thread in the CLI and its ranks, as in _one_thread
    out = subprocess.run(
        [sys.executable, "-m", "piecewise_icp_torch", "pair", "--config",
         str(files["conf"]), "--out", str(tmp_path / "cli_"),
         "--mesh-devices", "2", "--device", "cpu", "--reference-semantics"],
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_S,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    rep = formats.read_trans_matrix_report(str(tmp_path / "cli_")
                                           + "TransMatrix.txt")
    assert np.isfinite(rep["trans_mat"]).all()


def test_cli_mesh_devices_on_cuda_raises_without_the_cards(files, tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are visible: NCCL can run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli_main(["pair", "--config", str(files["conf"]), "--out",
                  str(tmp_path / "x_"), "--mesh-devices", "2",
                  "--device", "cuda"])


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------


def test_a_raising_rank_ends_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: ``launch`` raises
    with rank 1's error (not the ``TimeoutError`` of its deadline, which
    rank 0's wait would reach), and no rank is left."""
    with pytest.raises(Exception, match="rank 1 fails on purpose") as err:
        launch(_raising_rank, 2, device="cpu", timeout=SPAWN_S)
    assert type(err.value).__name__ == "ProcessRaisedException"
    assert not multiprocessing.active_children()


def test_check_replicated_sees_one_bit(ranks):
    """Equal inputs pass on every rank; one bit flipped on one rank raises
    ``PwICPError`` on every rank (so none is left waiting)."""
    assert ranks["replicated"] == [(False, True)] * ranks["nproc"]


def test_make_group_is_the_default_group(ranks):
    """In a rank, ``make_group`` gives the process group that ``launch``
    joined (rank 0 of ``nproc``, gloo, the CPU) and ``is_multiprocess``
    holds; outside one it holds not, and ``make_group`` raises."""
    assert ranks["default"] == (True, 0, ranks["nproc"], "cpu", "gloo")
    assert not is_multiprocess()
    with pytest.raises(RuntimeError, match="no process group"):
        make_group()


def test_pad_and_shard_rows():
    """Three ranks: 7 rows padded to 9 with the value given, and rank r's
    contiguous block of 3 (a view of the padded rows)."""
    x = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    for r in range(3):
        g = ShardGroup(r, 3, torch.device("cpu"), "gloo")
        p = g.pad_rows(x, -1)
        assert p.shape == (9, 2) and bool((p[7:] == -1).all())
        s = g.shard(p)
        assert s.shape == (3, 2) and s.data_ptr() == p[3 * r].data_ptr()
        with pytest.raises(ValueError):
            g.shard(x)
    assert ShardGroup(0, 1, torch.device("cpu"), "gloo").pad_rows(x) is x


@pytest.mark.parametrize("device,backend,match", [
    ("cpu", "nccl", "gloo"), ("cuda", None, "CUDA device"),
    ("cuda", "gloo", "CUDA device"), ("cpu", "mpi", "unsupported")])
def test_backend_is_chosen_explicitly(device, backend, match):
    """No drop from NCCL to gloo or from the card to the CPU: a launch
    that cannot run as asked raises before any rank starts."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises((RuntimeError, ValueError), match=match):
        launch(_raising_rank, 2, device=device, backend=backend,
               timeout=SPAWN_S)
