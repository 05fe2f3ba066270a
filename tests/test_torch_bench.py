"""PyTorch port, ``bench_torch.py`` (the counterpart of the JAX package's
``bench.py``) on the CPU at a reduced size: its line carries a counterpart
of every key of ``bench.py``'s line (the table below, with the keys it
drops and why), its errors are the JAX package's ``matrix_to_params_gon``
of the same two matrices, its pair agrees with the JAX package's own
``register_pair`` (TPU branch forced on the CPU), the bound arithmetic
gives the hand count on a hand-built grid, and without a card and without
``--device cpu`` the script exits non-zero with no line."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from piecewise_icp_tpu.config import PiecewiseICPConfig as JaxConfig
from piecewise_icp_tpu.ops.transform import matrix_to_params_gon

from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid
from piecewise_icp_torch.utils import measure

from test_torch_pairwise import corner_gap, truth_residual
from test_torch_rockfall import j_pairwise, jax_tpu_branch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

# the reduced bench: 6,400 points an epoch, all kept by the voxel grid of
# 16 mm (the unified path); at this size neither the pair nor a pair of the
# campaign draws the acceptance guard's extra lattices (each draw is a whole
# registration more)
SEED, N_SIDE, RES = 0, 80, 0.016

# bench.py's key (dotted where nested) -> the port's key
KEY_MAP = {
    "metric": "metric",
    "value": "value",
    "unit": "unit",
    "warm_s": "warm_s",
    "campaign_epoch_s": "campaign_epoch_s",
    "campaign_epochs_per_s": "campaign_epochs_per_s",
    "campaign_serial_epoch_s": "campaign_serial_epoch_s",
    "campaign_note": "campaign_note",
    "cold_s": "cold_s",
    # a fresh process with the kernel library built (no compile cache)
    "cache_hit_cold_s": "cold_fresh_s",
    # one card, and no launch floor subtracted (each inner iteration's host
    # read is part of the rate)
    "icp_iters_per_s_per_chip": "icp_iters_per_s",
    "icp_metric_note": "icp_metric_note",
    "icp_iters_warm_pair": "icp_iters_warm_pair",
    "variance.warm_s": "variance.warm_s",
    "variance.campaign_epoch_s": "variance.campaign_epoch_s",
    "variance.campaign_serial_epoch_s": "variance.campaign_serial_epoch_s",
    "variance.note": "variance.note",
    "rot_err_mgon": "rot_err_mgon",
    "trans_err_mm": "trans_err_mm",
    "symmetric_icp.rot_err_mgon": "symmetric_icp.rot_err_mgon",
    "symmetric_icp.trans_err_mm": "symmetric_icp.trans_err_mm",
    "nn_kernels.n_points": "nn_kernels.n_points",
    "nn_kernels.dispatch_floor_ms": "nn_kernels.launch_floor_ms",
    "nn_kernels.xla_brute_ms": "nn_kernels.library_brute_ms",
    "nn_kernels.pallas_brute_ms": "nn_kernels.brute_kernel_ms",
    "nn_kernels.grid_pallas_slab_ms": "nn_kernels.range_nn1_ms",
    "nn_kernels.grid_pallas_selfjoin_ms": "nn_kernels.knn_sorted_ms",
    "nn_kernels.grid_production_exact_ms": "nn_kernels.range_nn1_sorted_ms",
    "nn_kernels.roofline.model": "nn_kernels.roofline.model",
    "nn_kernels.roofline.brute_sol_ms":
        "nn_kernels.roofline.nn1_brute.bound_ms",
    "nn_kernels.roofline.brute_pallas_pct_of_sol":
        "nn_kernels.roofline.nn1_brute.share_pct",
    "nn_kernels.roofline.grid_slab1_sol_ms":
        "nn_kernels.roofline.range_nn1.bound_ms",
    "nn_kernels.roofline.grid_selfjoin_sol_ms":
        "nn_kernels.roofline.knn_sorted.bound_ms",
    "nn_kernels.roofline.grid_pallas_pct_of_sol":
        "nn_kernels.roofline.knn_sorted.share_pct",
    "phases": "phases",
    "fine_phases": "fine_phases",
    "device": "device.name",
}
# bench.py's keys without a counterpart, and why
DROPPED = {
    "vs_baseline": "its base, 0.0924 epochs/s, is a TPU measurement",
    "nn_kernels.grid_xla_gather_ms": "the XLA gather grid query is on "
    "ROADMAP's Do not port list; the line's nn_kernels.note says so",
}


def _bench_py_keys() -> set:
    """The keys of ``bench.py``'s line, read from the dict literals it
    prints (``out``, with ``nn_kernels`` the dict ``nn_bench``)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dicts = {node.targets[0].id: node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and isinstance(node.targets[0], ast.Name)
             and isinstance(node.value, ast.Dict)}

    def keys(d: ast.Dict, prefix: str):
        for k, v in zip(d.keys, d.values):
            name = prefix + k.value
            if isinstance(v, ast.Name) and v.id in dicts:
                v = dicts[v.id]
            if isinstance(v, ast.Dict):
                yield from keys(v, name + ".")
            else:
                yield name

    return set(keys(dicts["out"], ""))


def _get(line: dict, key: str):
    for part in key.split("."):
        line = line[part]
    return line


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """The script on the CPU at the reduced size, one repeat, in a process
    of its own with two intra-op threads (the JAX package's pair runs
    meanwhile; with all cores, the script and the suite's other workers
    slow each other down)."""
    tmp = tmp_path_factory.mktemp("bench")
    with open(tmp / "out", "w") as out, open(tmp / "err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "bench_torch.py", "--device", "cpu", "--seed",
             str(SEED), "--n-side", str(N_SIDE), "--res", str(RES),
             "--warm-reps", "1", "--reps", "1"],
            stdout=out, stderr=err, cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def line(bench_run):
    """The script's line (about 46 s alone; several times that beside the
    suite's other workers)."""
    proc, tmp = bench_run
    assert proc.wait(timeout=900) == 0, (tmp / "err").read_text()[-4000:]
    return json.loads((tmp / "out").read_text().strip().splitlines()[-1])


def test_pair_matches_jax_register_pair(bench_run, request):
    """The bench pair through the JAX package's own ``register_pair`` (its
    TPU branch forced on the CPU), with the twin of the bench's
    configuration: within test_torch_pairwise.py's 0.5 mm at the source's
    box corners, both within the truth bounds."""
    c1, c2, t_true = bench_torch.bench_pair(SEED, N_SIDE)
    jcfg = JaxConfig(set_res_svsize=True, res1=RES, res2=RES,
                     svsize1=10 * RES, svsize2=10 * RES, set_dtinit=True,
                     dt_init=0.05, dt_min=0.004, segmentation_impl="jax")
    assert config_from_jax(jcfg) == bench_torch.bench_config(RES)
    with jax_tpu_branch():
        ref = j_pairwise.register_pair(c1, c2, jcfg,
                                       sor_mult=jcfg.sor_std_mult_4d)
    got = np.array(request.getfixturevalue("line")["trans_mat"])
    assert corner_gap(got, ref.trans_mat, c2) < 5e-4
    for t in (got, ref.trans_mat):
        disp = truth_residual(t, t_true, c2)
        assert disp.mean() < 2e-3 and disp.max() < 5e-3


def test_the_table_covers_bench_py():
    assert set(KEY_MAP) | set(DROPPED) == _bench_py_keys()
    assert not set(KEY_MAP) & set(DROPPED)


def test_line_carries_every_key(line):
    for key in KEY_MAP.values():
        _get(line, key)                     # raises KeyError when missing
    assert not bench_torch.missing_keys(line)
    for src in DROPPED:
        with pytest.raises(KeyError):
            _get(line, src)
    assert line["metric"] == "epochs/s" and line["unit"] == "epochs/s"
    assert line["value"] == 1.0 / line["warm_s"]
    lo, mid, hi = line["variance"]["warm_s"]
    assert lo <= mid <= hi and mid == line["warm_s"]
    # a CPU run names the CPU and states no share of the card's bound
    assert line["device"] == {"name": "cpu", "power_limit": None, "count": 0}
    nn = line["nn_kernels"]
    assert nn["n_points"] > 4096
    for name in ("nn1_brute", "range_nn1", "range_nn1_sorted", "knn_sorted",
                 "knn_brute"):
        roof = nn["roofline"][name]
        assert roof["bound_ms"] > 0 and roof["share_pct"] is None
        assert roof["bound_by"] in ("bytes", "operations")
    # the plain versions ran: no kernel launched, none on a CUDA tensor
    assert line["launches"] == {} and line["plain_on_cuda"] == {}
    assert line["cold_fresh_s"] > 0 and line["build_s"] is None
    assert line["campaign_errors"]["rot_max_mgon"] < 200.0
    assert line["campaign_errors"]["trans_max_mm"] < 5.0


def test_errors_are_the_jax_packages(line):
    """rot_err_mgon / trans_err_mm: the JAX package's parameter vectors of
    the estimate and of the inverse of the true transform."""
    _, c2, t_true = bench_torch.bench_pair(SEED, N_SIDE)
    t_est = np.array(line["trans_mat"])
    err = matrix_to_params_gon(t_est) \
        - matrix_to_params_gon(np.linalg.inv(t_true))
    assert line["rot_err_mgon"] == float(np.abs(err[:3]).max() * 1000)
    assert line["trans_err_mm"] == float(np.abs(err[3:]).max() * 1000)
    disp = truth_residual(t_est, t_true, c2)
    assert line["residual_mean_mm"] == pytest.approx(1e3 * disp.mean(),
                                                     rel=1e-12)
    assert line["residual_max_mm"] == pytest.approx(1e3 * disp.max(),
                                                    rel=1e-12)


def test_bound_on_a_hand_built_grid():
    """Four points on a line of 1 m cells: two in cell 0, one in cell 1,
    one in cell 3 (cell 2 empty).  The self-join's windows hold 3, 3, 3 and
    1 candidates; a query in cell 2 meets 2, one left of the grid (clamped
    into cell 0) meets 3."""
    pts = np.array([[0.1, 0, 0], [0.2, 0, 0], [1.5, 0, 0], [3.5, 0, 0]],
                   np.float32)
    grid = CellGrid.from_index(build_grid(pts, 1.0), torch.device("cpu"))
    assert grid.dims == (4, 1, 1) and grid.n == 4 and grid.n_cells == 4
    assert measure.window_pairs(grid) == 10
    q = torch.tensor([[2.6, 0, 0], [-5.0, 0, 0]])
    assert measure.window_pairs(grid, q) == 5
    assert measure.window_pairs(grid, q, torch.tensor([True, False])) == 2

    def ms(n_bytes, n_ops):
        # the data sheet's 3.35 TB/s, and 67e12 / 2 lane instructions a second
        return max(1e3 * n_bytes / 3.35e12, 1e3 * n_ops / 33.5e12)

    # K1: grid 12*4 + 4*5, queries 12*2, outputs 13*2 + 4; 9 a candidate
    k1 = measure.range_nn1_bound(grid, 2, False, 5)
    assert k1["bound_ms"] == ms(122, 45) and k1["bound_by"] == "bytes"
    # K2 with k = 2: grid 68, mask 4, 8*4*2 out; 9 a candidate + 4*2*1
    k2 = measure.knn_sorted_bound(grid, 2, 10)
    assert k2["bound_ms"] == ms(136, 98) and k2["bound_by"] == "bytes"
    # K5, 2 queries x 4 targets, no masks: 24 + 48 in, 16 out; 9 a pair
    k5 = measure.nn1_brute_bound(2, 4, 8, False, False)
    assert k5["bound_ms"] == ms(88, 72) and k5["bound_by"] == "bytes"
    # K6, 2 queries x 4 targets, one SOR mean a query: 24 + 48 in, 8 out
    k6 = measure.knn_brute_bound(2, 4, 8, False, 1)
    assert k6["bound_ms"] == ms(80, 72) and k6["bound_by"] == "bytes"
    # 1e6 pairs of masked K5: 9e6 instructions outlast 34,000 bytes
    big = measure.nn1_brute_bound(1000, 1000, 10**6, True, True)
    assert big["bound_ms"] == ms(34000, 9e6)
    assert big["bound_by"] == "operations"


def test_without_a_card_exits_nonzero_with_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr



def test_bench_pair_is_the_smoke_pair():
    """The bench registers chip_smoke.py's smoke pair with bench.py's
    configuration, which is the port's default."""
    import chip_smoke

    from piecewise_icp_torch.config import PiecewiseICPConfig

    assert (bench_torch.N_SIDE, bench_torch.EXTENT, bench_torch.PARAMS,
            bench_torch.RES) == (chip_smoke.N_SIDE, chip_smoke.EXTENT,
                                 chip_smoke.PARAMS, chip_smoke.RES)
    assert bench_torch.bench_config() == PiecewiseICPConfig()
