"""PyTorch port, the 4D campaign: chaining and Kalman smoothing held against
the JAX package's, the port's ``run_4d`` end to end on the CPU (adaptive
planning, auto DT-init, the staged path of ~3,600-point epochs, Kalman),
finalisation byte for byte against the JAX package's from the same pair
files, epoch-fleet shards and resume, and the ``4d`` command line."""

import inspect
import os
import shutil
import time

import numpy as np
import pytest
import torch

from piecewise_icp_tpu.io import formats, write_pcd
from piecewise_icp_tpu.models import chaining as jchain
from piecewise_icp_tpu.models import kalman as jkal
from piecewise_icp_tpu.models.four_d import run_4d as j_run_4d
from piecewise_icp_tpu.ops.transform import matrix_to_params_gon, \
    params_to_matrix

from piecewise_icp_torch.__main__ import main as cli_main
from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models import chaining as tchain
from piecewise_icp_torch.models import four_d
from piecewise_icp_torch.models import kalman as tkal
from piecewise_icp_torch.models.four_d import run_4d
from piecewise_icp_torch.utils.synth import make_series, write_ground_truth

from util import small_test_config

N_EPOCHS = 4
OUTPUTS = ("TransMatrices.txt", "TransParameters.txt",
           "TransMatrices_toRef.txt", "TransParameters_toRef.txt",
           "TransPara_AbsError.txt", "TransMatrices_toRef_smoothed.txt",
           "TransParameters_toRef_smoothed.txt",
           "TransPara_AbsError_smoothed.txt")


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """Four epochs of ~3,600 points (under the unified path's 4,096-point
    floor) with random-walk ground truth, as ``tests/test_4d.py``."""
    root = tmp_path_factory.mktemp("series")
    scans = root / "scans"
    scans.mkdir()
    epochs, gt = make_series(np.random.default_rng(42), N_EPOCHS, n_side=60)
    for k, e in enumerate(epochs):
        write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
    write_ground_truth(root / "defined_transformations.txt", gt)
    return root, scans, gt


@pytest.fixture(scope="module")
def campaign(series):
    """The port's adaptive campaign with auto DT-init and Kalman smoothing,
    run once on the CPU."""
    root, scans, gt = series
    out = root / "out_adaptive"
    cfg = small_test_config(path1=str(scans), path2=str(out) + os.sep,
                            set_dtinit=False, kalman_enabled=True,
                            kalman_process_noise=1e-6)
    ok = run_4d(config_from_jax(cfg), 0, N_EPOCHS, -1, device="cpu")
    return ok, out, gt


def _seq(rng, n=9):
    tms = [params_to_matrix(rng.normal(scale=[2e-3] * 3 + [5e-3] * 3))
           for _ in range(n)]
    vcms = []
    for _ in range(n):
        a = rng.normal(size=(6, 6)) * 1e-4
        vcms.append(a @ a.T + 1e-10 * np.eye(6))
    return tms, vcms


@pytest.mark.parametrize("mode", [0, 2, -1])
def test_chaining_and_kalman_match_jax(rng, mode):
    tms, vcms = _seq(rng)
    plan = ({1: 0, 2: 0, 3: 2, 4: 3, 5: 3, 6: 5, 7: 5, 8: 7, 9: 8}
            if mode < 0 else None)
    jt, jv = jchain.chain_to_reference(tms, vcms, mode, plan)
    tt, tv = tchain.chain_to_reference(tms, vcms, mode, plan)
    for a, b in zip(tt + tv, jt + jv):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    gt = [params_to_matrix(rng.normal(scale=1e-2, size=6)) for _ in tms]
    np.testing.assert_allclose(tchain.absolute_errors(tt, gt),
                               jchain.absolute_errors(jt, gt),
                               rtol=0, atol=1e-12)
    for noise in ("auto", 1e-6, np.full(6, 1e-7)):
        js = jkal.kalman_smooth_transforms(jt, jv, noise)
        ts = tkal.kalman_smooth_transforms(tt, tv, noise)
        for f in ("params", "covariances", "filtered"):
            np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                       rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.stack(ts.trans_mats),
                                   np.stack(js.trans_mats),
                                   rtol=0, atol=1e-12)


def test_run_4d_adaptive_auto_dtinit(campaign, series):
    ok, out, gt = campaign
    assert ok
    for name in OUTPUTS + ("RegPairFile.txt", "phase_timings.jsonl"):
        assert (out / name).exists(), name
    for step in range(1, N_EPOCHS):
        assert (out / "pairs" / f"pair_{step:04d}.npz").exists()
        assert (out / f"{step + 1}_Adaptive_TransMatrix.txt").exists()
    plan = formats.read_reg_pairs(out / "RegPairFile.txt")
    assert sorted(plan) == [1, 2, 3] and all(plan[s] < s for s in plan)

    ts, _, _ = formats.read_trans_matrices(out / "TransMatrices_toRef.txt",
                                           N_EPOCHS - 1)
    assert ts == [2, 3, 4]
    errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
    assert errors.shape == (N_EPOCHS - 1, 6)
    # the bounds of tests/test_4d.py: 0.2 gon, 5 mm
    assert errors[:, :3].max() < 200.0
    assert errors[:, 3:].max() < 5.0
    # smoothing does not degrade the accuracy against the ground truth
    raw = formats.read_trans_parameters(out / "TransParameters_toRef.txt")
    sm = formats.read_trans_parameters(
        out / "TransParameters_toRef_smoothed.txt")
    assert np.isfinite(sm).all() and (raw[:, 7:] >= 0).all()
    gt_params = np.stack([matrix_to_params_gon(g) for g in gt[1:]])
    raw_err = np.abs(raw[:, 1:7] - gt_params).mean()
    sm_err = np.abs(sm[:, 1:7] - gt_params).mean()
    assert sm_err <= raw_err * 1.25 + 1e-4


@pytest.mark.parametrize("mode", [0, 1, -1])
def test_finalisation_matches_jax(campaign, series, tmp_path, mode):
    """From the same pair files, the JAX package's finalisation and the
    port's write byte-identical tables."""
    _, out, _ = campaign
    _, scans, _ = series
    texts = {}
    for name, fn, twin, kw in (
            ("jax", j_run_4d, lambda c: c, {}),
            ("torch", run_4d, config_from_jax, dict(device="cpu"))):
        d = tmp_path / name
        shutil.copytree(out / "pairs", d / "pairs")
        shutil.copy(out / "RegPairFile.txt", d / "RegPairFile.txt")
        cfg = small_test_config(path1=str(scans), path2=str(d) + os.sep,
                                kalman_enabled=True)
        assert fn(twin(cfg), 0, N_EPOCHS, mode, resume=True, **kw)
        texts[name] = {p.name: p.read_bytes() for p in d.glob("*.txt")}
    assert set(texts["torch"]) == set(texts["jax"]) >= set(OUTPUTS)
    for f, want in texts["jax"].items():
        assert texts["torch"][f] == want, f


def test_shards_and_resume(series, tmp_path):
    """Two shards split the pair list over one output folder, the second
    finalises, and a resume run replays the pair files without
    registering anything."""
    root, scans, _ = series
    out = tmp_path / "out_sh"
    cfg = config_from_jax(small_test_config(
        path1=str(scans), path2=str(out) + os.sep, guard_enabled=False))
    gt_file = str(root / "defined_transformations.txt")
    assert run_4d(cfg, 0, N_EPOCHS, 0, ground_truth=gt_file,
                  shard_index=0, shard_count=2, device="cpu")
    assert (out / "pairs" / "pair_0001.npz").exists()
    assert (out / "pairs" / "pair_0002.npz").exists()
    assert not (out / "pairs" / "pair_0003.npz").exists()
    assert not (out / "TransMatrices_toRef.txt").exists()

    assert run_4d(cfg, 0, N_EPOCHS, 0, ground_truth=gt_file,
                  shard_index=1, shard_count=2, device="cpu")
    first = (out / "TransMatrices_toRef.txt").read_text()

    t0 = time.perf_counter()
    assert run_4d(cfg, 0, N_EPOCHS, 0, ground_truth=gt_file, resume=True,
                  device="cpu")
    assert time.perf_counter() - t0 < 5.0
    assert (out / "TransMatrices_toRef.txt").read_text() == first
    errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
    assert errors[:, :3].max() < 200.0 and errors[:, 3:].max() < 5.0


def test_cli_4d(campaign, series, tmp_path):
    _, out, _ = campaign
    _, scans, _ = series
    d = tmp_path / "cli"
    shutil.copytree(out / "pairs", d / "pairs")
    shutil.copy(out / "RegPairFile.txt", d / "RegPairFile.txt")
    conf = tmp_path / "config_4d.txt"
    small_test_config(path1=str(scans), path2=str(d) + os.sep
                      ).to_reference_file(conf)
    assert cli_main(["4d", "--config", str(conf), "--epochs",
                     str(N_EPOCHS), "--mode", "-1", "--kalman", "--resume",
                     "--device", "cpu"]) == 0
    for name in OUTPUTS:
        assert (d / name).exists(), name


def test_cli_4d_reference_semantics(monkeypatch, tmp_path):
    """``--reference-semantics`` turns off all four beyond-reference
    features in the configuration the 4D campaign receives."""
    seen = []
    monkeypatch.setattr(four_d, "run_4d",
                        lambda cfg, *a, **kw: seen.append((cfg, kw)) or True)
    conf = tmp_path / "config_4d.txt"
    small_test_config(path1=str(tmp_path), path2=str(tmp_path / "out")
                      ).to_reference_file(conf)
    assert cli_main(["4d", "--config", str(conf), "--epochs", "3",
                     "--reference-semantics", "--icp-variant", "reference",
                     "--device", "cpu"]) == 0
    (cfg, kw), = seen
    assert not cfg.change_screen and not cfg.guard_enabled
    assert cfg.robust_refine is False and not cfg.warm_start_direct
    assert not cfg.kalman_enabled and kw["device"] == "cpu"


def test_cli_4d_symmetric_icp_out_of_slice(series, tmp_path):
    """A 3-epoch campaign with ``--icp-variant symmetric`` through the
    ``4d`` command line writes every table within the truth bounds."""
    _, scans, _ = series
    out = tmp_path / "out"
    conf = tmp_path / "config_4d.txt"
    small_test_config(path1=str(scans), path2=str(out) + os.sep,
                      guard_enabled=False).to_reference_file(conf)
    assert cli_main(["4d", "--config", str(conf), "--epochs", "3",
                     "--mode", "-1", "--kalman", "--icp-variant",
                     "symmetric", "--device", "cpu"]) == 0
    for name in OUTPUTS:
        assert (out / name).exists(), name
    errors = formats.read_abs_errors(out / "TransPara_AbsError.txt")
    assert errors.shape == (2, 6)
    assert errors[:, :3].max() < 200.0 and errors[:, 3:].max() < 5.0


@pytest.mark.parametrize("fn", [four_d.adaptive_pair_sequence, four_d.run_4d,
                                four_d.piecewise_icp_4d_call],
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    """The campaign's entry points run on the card unless the caller names
    another device."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_call_without_device_raises_without_a_card(series, tmp_path):
    """No quiet drop to the CPU: where no GPU is visible, a campaign that
    names no device raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    _, scans, _ = series
    out = tmp_path / "out"
    cfg = config_from_jax(small_test_config(path1=str(scans),
                                            path2=str(out) + os.sep))
    conf = tmp_path / "config_4d.txt"
    cfg.to_reference_file(conf)
    files = sorted(str(p) for p in scans.glob("*.pcd"))
    for call in (lambda: run_4d(cfg, 0, N_EPOCHS, -1),
                 lambda: four_d.piecewise_icp_4d_call(str(conf), 0,
                                                      N_EPOCHS, -1),
                 lambda: four_d.adaptive_pair_sequence(files, 0, 0.05,
                                                       0.75)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not out.exists()
