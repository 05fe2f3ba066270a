"""PyTorch port, BASELINE configuration 5 (``utils/scale.py``): the series
and the quasi-static series byte for byte against ``eval/scale_demo.py``
and ``eval/kalman_quasistatic.py``, their configurations the twins of the
eval modules', the epoch fleet on the CPU (two concurrent worker processes
against one, against the in-process campaign and against the JAX
package's finalisation from the fleet's pair files), its failures, the
quasi-static report by hand, pair files written whole, and one kernel
build across processes.

The fleet's series is 6 epochs of 3,600 points (5 pairs, split 3 + 2
between two workers): at this size the acceptance guard draws several
lattices a pair, which keeps a pair near 2 s on the CPU.
"""

import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import piecewise_icp_tpu.io as jio
from piecewise_icp_tpu.config import PiecewiseICPConfig as JConfig
from piecewise_icp_tpu.models.four_d import run_4d as j_run_4d

from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.io import formats
from piecewise_icp_torch.models import four_d
from piecewise_icp_torch.models.four_d import run_4d
from piecewise_icp_torch.ops.transform import (matrix_to_params_gon,
                                               params_to_matrix)
from piecewise_icp_torch.utils import scale
from piecewise_icp_torch.utils.synth import terrain_cloud

EVAL = pathlib.Path(__file__).resolve().parent.parent / "eval"
sys.path.insert(0, str(EVAL))

import kalman_quasistatic  # noqa: E402
import scale_demo  # noqa: E402

EPOCHS = 6
# the series' scale cut to ~3,600-point epochs (33 mm spacing)
SMALL = dict(res1=0.022, res2=0.022, svsize1=0.22, svsize2=0.22)
# a worker's threads: the tier-1 run shares the cores among its own workers
THREADS = 2


def _base(n_side: int = 60) -> np.ndarray:
    return terrain_cloud(np.random.default_rng(0), n_side=n_side)


@pytest.mark.parametrize("downsample", [0.0, 0.05])
def test_series_byte_identical_to_eval(tmp_path, monkeypatch, downsample):
    """The same base: the same scans and ground truth, byte for byte, as
    ``eval/scale_demo.generate_series`` (whose ``REF_SCAN`` read returns
    the base here)."""
    base = _base()
    monkeypatch.setattr(jio, "read_pcd", lambda path: base)
    a = scale_demo.generate_series(str(tmp_path / "eval"), 9,
                                   downsample=downsample)
    b = scale.generate_series(str(tmp_path / "port"), 9, base,
                              downsample=downsample)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names[0] == "Epoch_0001.pcd" and len(names) == 9
    for name in names + ["../defined_transformations.txt"]:
        assert (pathlib.Path(a, name).read_bytes()
                == pathlib.Path(b, name).read_bytes()), name


def test_quasistatic_byte_identical_to_eval(tmp_path, monkeypatch):
    base = _base()
    monkeypatch.setattr(jio, "read_pcd", lambda path: base)
    kalman_quasistatic.generate(str(tmp_path / "eval"), 9)
    scans = scale.generate_quasistatic(str(tmp_path / "port"), 9, base)
    assert scans == str(tmp_path / "port" / "scans")
    files = sorted(os.listdir(scans))
    assert files[0] == "Epoch_001.pcd" and len(files) == 9
    for name in ["scans/" + f for f in files] \
            + ["defined_transformations.txt"]:
        assert ((tmp_path / "eval" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name


def test_default_base_is_the_reference_size():
    assert scale.default_base().shape == (142_884, 3)


@pytest.mark.parametrize("which", ["scale", "quasistatic"])
def test_configs_are_the_eval_twins(which):
    """scale_demo's and kalman_quasistatic's configurations (the values of
    their ``main``) and the port's."""
    common = dict(path1="s", path2="o/", set_res_svsize=True, res1=0.005,
                  res2=0.005, svsize1=0.05, svsize2=0.05, set_dtinit=True,
                  dt_init=0.05, dt_min=0.004, kalman_enabled=True)
    if which == "scale":
        jcfg = JConfig(**common, epoch_digits=4)
        cfg = scale.scale_config("s", "o/")
    else:
        jcfg = JConfig(**common)
        cfg = scale.quasistatic_config("s", "o/")
    assert type(cfg).__module__ == "piecewise_icp_torch.config"
    assert cfg == config_from_jax(jcfg)


# ---------------------------------------------------------------------------
# the fleet on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def series(tmp_path_factory):
    root = tmp_path_factory.mktemp("scale")
    scans = scale.generate_series(str(root), EPOCHS, _base())
    return root, scans, str(root / "defined_transformations.txt")


def _poll_pairs(pairs_dir: str, stop: threading.Event, seen: dict,
                errors: list) -> None:
    """Load every pair file as soon as it is listed, until ``stop``."""
    while not stop.is_set():
        for f in glob.glob(os.path.join(pairs_dir, "pair_*.npz")):
            try:
                with np.load(f) as d:
                    seen[f] = float(d["tm"].sum() + d["vcm"].sum())
            except Exception as e:      # a partial file, whatever the error
                errors.append((f, repr(e)))
        time.sleep(0.005)


@pytest.fixture(scope="module")
def fleets(series):
    """The series as a fleet of 1 worker and of 2 (a reader polling their
    pair files meanwhile), and in this process (``os.replace`` watched)."""
    root, scans, gt = series
    runs = {}
    for w in (1, 2):
        out = str(root / f"out_{w}w")
        stop, seen, errors = threading.Event(), {}, []
        reader = threading.Thread(target=_poll_pairs, args=(
            os.path.join(out, "pairs"), stop, seen, errors))
        reader.start()
        try:
            rec = scale.run_fleet(
                scale.scale_config(scans, out, **SMALL), out, EPOCHS, 1, w,
                device="cpu", threads=THREADS, ground_truth=gt,
                baseline_s=runs[1][0]["pairs_wall_s"] if w > 1 else None,
                timeout=600)
        finally:
            stop.set()
            reader.join(timeout=30)
        assert not reader.is_alive()
        runs[w] = (rec, out, seen, errors)

    out = str(root / "in_process") + os.sep
    replaced = []
    real = os.replace

    def spy(src, dst):
        replaced.append((str(src), str(dst)))
        real(src, dst)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "replace", spy)
        assert run_4d(scale.scale_config(scans, out, **SMALL), 0, EPOCHS, 1,
                      ground_truth=gt, device="cpu")
    runs[0] = (None, out, None, replaced)
    return runs


def test_fleet_tables_equal_one_worker_and_in_process(fleets):
    digests = {w: scale.table_digests(fleets[w][1]) for w in (0, 1, 2)}
    assert digests[2] == digests[1] == digests[0]


def test_fleet_record(fleets, series):
    _, scans, gt = series
    for w in (1, 2):
        rec, out, _, _ = fleets[w]
        assert rec["workers"] == w and rec["worker_rcs"] == [0] * w
        assert rec["devices"] == ["cpu"] * w
        assert rec["pairs"] == EPOCHS - 1
        assert rec["threads_per_worker"] == THREADS
        assert rec["worker_threads"] == [THREADS] * w
        assert len(rec["worker_cpu_s"]) == w and min(rec["worker_cpu_s"]) > 0
        assert 0 < rec["host_busy_pct"]
        assert 0 < min(rec["worker_startup_s"])
        assert max(rec["worker_startup_s"]) < rec["pairs_wall_s"]
        assert len(rec["per_worker_done_s"]) == w
        assert max(rec["per_worker_done_s"]) <= rec["pairs_wall_s"]
        assert rec["epochs_per_s"] == pytest.approx(
            (EPOCHS - 1) / rec["pairs_wall_s"])
        assert rec["finalize_wall_s"] > 0
        # the plain versions ran: no launch, nothing plain on a card
        assert rec["launches"] == [{}] * w
        assert rec["plain_on_cuda"] == [{}] * w
        for name in scale.FLEET_TABLES + ("phase_timings.jsonl",):
            assert os.path.exists(os.path.join(out, name)), name
        assert sorted(os.listdir(os.path.join(out, "pairs"))) == [
            f"pair_{s:04d}.npz" for s in range(1, EPOCHS)]
        # 4-digit timestamps read as such: epochs 2..6, one report each
        params = formats.read_trans_parameters(
            os.path.join(out, "TransParameters.txt"))
        assert params[:, 0].tolist() == list(range(2, EPOCHS + 1))
        assert sorted(glob.glob(os.path.join(out, "*_Fixed_TransMatrix.txt"))
                      ) == [os.path.join(out, f"{s}_Fixed_TransMatrix.txt")
                            for s in range(2, EPOCHS + 1)]
        res = scale.pair_residuals_mm(out, scans, gt, EPOCHS - 1)
        assert res[:, 0].max() < 2.0 and res[:, 1].max() < 5.0
    one, two = fleets[1][0], fleets[2][0]
    assert "speedup_vs_1" not in one
    assert two["speedup_vs_1"] == one["pairs_wall_s"] / two["pairs_wall_s"]
    assert two["efficiency_pct"] == 50 * two["speedup_vs_1"]


def test_jax_finalisation_from_the_fleets_pair_files(fleets, series,
                                                     tmp_path):
    """The JAX package's ``run_4d(..., resume=True)`` from the 2-worker
    fleet's pair files writes the same bytes as the fleet's finalise."""
    root, scans, gt = series
    _, out, _, _ = fleets[2]
    d = tmp_path / "jax"
    shutil.copytree(os.path.join(out, "pairs"), d / "pairs")
    jcfg = JConfig(path1=scans, path2=str(d) + os.sep, set_res_svsize=True,
                   set_dtinit=True, dt_init=0.05, dt_min=0.004,
                   epoch_digits=4, kalman_enabled=True, **SMALL)
    assert j_run_4d(jcfg, 0, EPOCHS, 1, ground_truth=gt, resume=True)
    for name in scale.FLEET_TABLES:
        assert ((d / name).read_bytes()
                == pathlib.Path(out, name).read_bytes()), name


def test_pair_files_whole_to_a_polling_reader(fleets):
    """A reader that loads each pair file as soon as it is listed, during
    both fleets, never meets a partial one."""
    for w in (1, 2):
        _, _, seen, errors = fleets[w]
        assert not errors
        assert len(seen) == EPOCHS - 1


def test_pair_files_arrive_by_replace(fleets):
    """Every pair file of the in-process campaign is renamed into place
    from a hidden temporary file of its own folder."""
    _, out, _, replaced = fleets[0]
    pairs = {os.path.join(out, "pairs", f"pair_{s:04d}.npz")
             for s in range(1, EPOCHS)}
    into = {dst: src for src, dst in replaced}
    assert pairs <= set(into)
    for dst in pairs:
        src = into[dst]
        assert os.path.dirname(src) == os.path.dirname(dst)
        assert os.path.basename(src).startswith(".")
    assert not [f for f in os.listdir(os.path.join(out, "pairs"))
                if f.startswith(".")]


@pytest.mark.parametrize("name", ["pair_0001.npz", "RegPairFile.txt"])
def test_write_whole(tmp_path, name):
    """The final name appears only once the writer has returned; a file
    that ``np.savez`` writes keeps its temporary name (no ``.npz``
    appended)."""
    target = tmp_path / name
    during = []

    def write(tmp):
        if name.endswith(".npz"):
            np.savez(tmp, tm=np.eye(4))
        else:
            formats.write_reg_pairs(tmp, {1: 0, 2: 1})
        during.append((tmp, target.exists(), sorted(os.listdir(tmp_path))))

    four_d._write_whole(str(target), write)
    (tmp, existed, listed), = during
    assert not existed and listed == [os.path.basename(tmp)]
    assert os.listdir(tmp_path) == [name]
    if name.endswith(".npz"):
        assert (np.load(target)["tm"] == np.eye(4)).all()
    else:
        assert formats.read_reg_pairs(target) == {1: 0, 2: 1}


def test_fleet_raises_when_a_worker_fails(tmp_path):
    """A configuration whose scan folder is missing: every worker exits
    non-zero and the fleet raises with the worker's log."""
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="fleet worker failed"):
        scale.run_fleet(scale.scale_config(str(tmp_path / "missing"), out,
                                           **SMALL), out, 3, 1, 2,
                        device="cpu", threads=1, timeout=300)
    reports = [json.loads(pathlib.Path(out, "fleet", f"worker_{i}.json")
                          .read_text()) for i in (0, 1)]
    assert [r["rc"] for r in reports] == [1, 1]


def test_fleet_raises_on_repeated_timestamps(series, tmp_path):
    """Three digits of the 4-digit names: every epoch's timestamp reads as
    0, and the fleet raises before it finalises."""
    _, scans, _ = series
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="timestamps repeat"):
        scale.run_fleet(scale.scale_config(scans, out, **SMALL), out, 3, 1,
                        1, device="cpu", threads=THREADS, epoch_digits=3,
                        timeout=300)
    assert not os.path.exists(os.path.join(out, "TransParameters.txt"))


def test_fleet_refuses_what_its_workers_cannot_carry(tmp_path):
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="guard_enabled"):
        scale.run_fleet(scale.scale_config("s", out, guard_enabled=False),
                        out, 3, 1, 1, device="cpu")


def test_fleet_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="is_available"):
        scale.run_fleet(scale.scale_config("s", out), out, 3, 1, 1)


def test_quasistatic_report_by_hand(tmp_path):
    """The report from tables written here, against numbers worked out
    from the same values."""
    rng = np.random.default_rng(3)
    n = 5
    z_raw = rng.normal(scale=2e-4, size=(n, 6))
    z_sm = 0.3 * z_raw + 1e-5
    err_raw = np.abs(rng.normal(size=(n, 6)))
    err_sm = 0.5 * err_raw
    ts = list(range(2, n + 2))
    for name, z in (("TransMatrices_toRef.txt", z_raw),
                    ("TransMatrices_toRef_smoothed.txt", z_sm)):
        formats.write_trans_matrices(
            tmp_path / name, ts, [params_to_matrix(p) for p in z],
            [np.eye(6)] * n)
    formats.write_abs_errors(tmp_path / "TransPara_AbsError.txt", err_raw)
    formats.write_abs_errors(tmp_path / "TransPara_AbsError_smoothed.txt",
                             err_sm)
    rep = scale.quasistatic_report(str(tmp_path), n + 1)

    raw = formats.read_abs_errors(tmp_path / "TransPara_AbsError.txt")
    sm = formats.read_abs_errors(tmp_path / "TransPara_AbsError_smoothed.txt")
    assert rep["raw_mean_rot_mgon"] == pytest.approx(raw[:, :3].mean(0))
    assert rep["smoothed_mean_trans_mm"] == pytest.approx(sm[:, 3:].mean(0))
    assert rep["rot_reduction"] == pytest.approx(
        raw[:, :3].mean() / sm[:, :3].mean())
    assert rep["trans_reduction"] == pytest.approx(
        raw[:, 3:].mean() / sm[:, 3:].mean())
    # the written matrices keep 12 decimals: the signed parameters in gon
    # and m come back within 1e-9 of those drawn
    gon = np.concatenate([z_raw[:, :3] * 200 / np.pi, z_raw[:, 3:]], axis=1)
    assert rep["common_mode_bias_rot_mgon"] == pytest.approx(
        gon[:, :3].mean(0) * 1000, abs=1e-5)
    assert rep["independent_component_reduction"] == pytest.approx(
        1 / 0.3, rel=1e-4)
    back = np.stack([matrix_to_params_gon(params_to_matrix(p))
                     for p in z_raw])
    assert np.allclose(back, gon, atol=1e-12)


def test_cli_quasistatic(tmp_path, capsys):
    """Four epochs of a 3,600-point base through ``run_quasistatic`` on the
    CPU: the report of its tables, and smoothing does not degrade the mean
    error (the criterion of ``tests/test_4d.py``)."""
    assert scale.main(["quasistatic", "--device", "cpu", "--workdir",
                       str(tmp_path), "--epochs", "4", "--n-side", "60",
                       "--res", "0.022"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] and rep["epochs"] == 4
    assert rep == {"ok": True, **scale.quasistatic_report(
        str(tmp_path / "results"), 4)}
    raw = formats.read_trans_parameters(
        tmp_path / "results" / "TransParameters_toRef.txt")
    sm = formats.read_trans_parameters(
        tmp_path / "results" / "TransParameters_toRef_smoothed.txt")
    assert np.abs(sm[:, 1:7]).mean() <= np.abs(raw[:, 1:7]).mean() * 1.25 \
        + 1e-4


def test_cli_series(tmp_path):
    assert scale.main(["series", "--workdir", str(tmp_path), "--epochs",
                       "3", "--n-side", "30"]) == 0
    assert sorted(os.listdir(tmp_path / "scans")) == [
        "Epoch_0001.pcd", "Epoch_0002.pcd", "Epoch_0003.pcd"]


# ---------------------------------------------------------------------------
# one kernel build across processes
# ---------------------------------------------------------------------------

STUB_NVCC = """#!/bin/sh
echo "$@" >> {log}
sleep 1
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo stub > "$2"; fi
  shift
done
"""

BUILD_SCRIPT = textwrap.dedent("""
    import os, pathlib, sys, time
    from piecewise_icp_torch.ops import _cuda
    root, me, peer = sys.argv[1:]
    _cuda.BUILD_ROOT = pathlib.Path(root)
    pathlib.Path(me).touch()
    while not os.path.exists(peer):     # both enter build() together
        time.sleep(0.01)
    print(_cuda.build())
""")


def test_one_build_across_processes(tmp_path):
    """Two processes that call ``build()`` at once with a slow ``nvcc``
    (a stub first on PATH that logs each call): one compile a source and
    one link in all, and both get the library."""
    from piecewise_icp_torch.ops import _cuda

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bin_dir / "nvcc"
    stub.write_text(STUB_NVCC.format(log=log))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(pathlib.Path(_cuda.__file__).parents[2]))
    root = tmp_path / "_build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(root),
         str(tmp_path / f"ready{i}"), str(tmp_path / f"ready{1 - i}")],
        env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = {o.strip().splitlines()[-1] for o in outs}
    assert len(libs) == 1 and pathlib.Path(libs.pop()).exists()
    calls = log.read_text().splitlines()
    n_sources = len(list(_cuda.CSRC.glob("*.cu")))
    assert sum(" -c " in c for c in calls) == n_sources, calls
    assert sum("-shared" in c for c in calls) == 1, calls
