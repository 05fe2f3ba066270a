"""PyTorch port, the rockfall configurations (BASELINE 3 and 4): the port's
copy of the rockfall series byte for byte against ``eval/rockfall_sim.py``,
the pair of epochs 1 and 2 on the staged path against the JAX package's
own ``register_pair`` with its TPU branch forced on the CPU, a 3-epoch
campaign through the port's ``4d`` command line against the JAX package's
``run_4d`` under the same branch, and the runner's summary.

The JAX package takes its TPU branch only where ``jax.default_backend()``
is ``"tpu"``; :func:`jax_tpu_branch` swaps in a copy of its unified
preparation without that check (nothing in the package changes), and the
tests give its configuration ``segmentation_impl="jax"``, so that its
staged segmentation (and the acceptance guard's re-draws) takes
``segment_patches_device`` too.  The reduced series is that of
``tests/test_rockfall_sim.py``: 60 m x 40 m at 0.45 m, seed 7, 3 epochs.
"""

import contextlib
import filecmp
import io
import itertools
import json
import os
import pathlib
import sys

import numpy as np
import pytest

import piecewise_icp_tpu.models.pairwise as j_pairwise
from piecewise_icp_tpu.io import formats
from piecewise_icp_tpu.io import read_pcd
from piecewise_icp_tpu.models.four_d import run_4d as j_run_4d
from piecewise_icp_tpu.models.segmentation_device import \
    preprocess_segment_device as j_preprocess_segment_device
from piecewise_icp_tpu.ops.preprocess import \
    voxel_downsample as j_voxel_downsample

from piecewise_icp_torch.__main__ import main as cli_main
from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.models.pairwise import register_pair
from piecewise_icp_torch.utils import rockfall

EVAL = pathlib.Path(__file__).resolve().parent.parent / "eval"
sys.path.insert(0, str(EVAL))

import rockfall_sim  # noqa: E402

EXTENT = (60.0, 40.0)
RES = 0.45
EPOCHS = 3


def _unified_any_backend(points, cfg, sor_mult, res, sv, lattice_offset):
    """``piecewise_icp_tpu.models.pairwise._prepare_cloud_unified`` without
    its ``jax.default_backend() == "tpu"`` check (``pairwise.py:60-63``)."""
    if os.environ.get("PWICP_NO_UNIFIED"):
        return None
    if cfg.segmentation_impl not in ("auto", "jax"):
        return None
    down = j_voxel_downsample(points, res)
    if down.shape[0] < 4096:
        return None
    seed_origin = None
    mn = down.astype(np.float64).min(axis=0)
    if cfg.seed_grid_align:
        seed_origin = np.floor(mn / sv) * sv
    if lattice_offset is not None:
        base = seed_origin if seed_origin is not None else mn
        seed_origin = base - np.mod(
            np.asarray(lattice_offset, np.float64), sv)
    out = j_preprocess_segment_device(
        down, res, cfg.sor_neighbors, sor_mult, sv, cfg.knn_normals,
        cfg, seed_origin=seed_origin)
    if out is None:
        return None
    ps, _nsv, kept = out
    return kept, ps


@contextlib.contextmanager
def record_draws(module):
    """Wrap ``module.piecewise_icp`` (the core of a ``register_pair``) to
    record every registration it runs: the first, then each acceptance-guard
    draw.  Yields the list of (sigma0, the de-reduced transform, the VCM)
    of each, in the order the pair ran them."""
    draws = []
    inner = module.piecewise_icp

    def wrapped(*args, **kw):
        core = inner(*args, **kw)
        shift = np.asarray(kw["lattice_shift"], np.float64)
        s, s_inv = np.eye(4), np.eye(4)
        s[:3, 3], s_inv[:3, 3] = shift, -shift
        draws.append((float(core.sigma0),
                      s_inv @ np.asarray(core.trans_mat, np.float64) @ s,
                      np.asarray(core.vcm, np.float64)))
        return core

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "piecewise_icp", wrapped)
        yield draws


@contextlib.contextmanager
def jax_tpu_branch():
    """The JAX package's ``register_pair`` and ``run_4d`` on their TPU
    branch on the CPU; yields the draws of every ``register_pair``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pairwise, "_prepare_cloud_unified",
                   _unified_any_backend)
        with record_draws(j_pairwise) as draws:
            yield draws


def rockfall_cfgs(scans: str, out_dir: str, **over):
    """The rockfall configuration of the JAX package (``segmentation_impl
    ="jax"``) at the reduced resolution, and the port's twin."""
    jcfg = rockfall_sim.rockfall_config(scans, out_dir, res=RES,
                                        segmentation_impl="jax", **over)
    return jcfg, config_from_jax(jcfg)


def corner_gap(t_a, t_b, pts) -> float:
    """Largest distance between the source's box corners moved by the two
    transforms."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c = np.array([[(lo, hi)[b][i] for i, b in enumerate(k)]
                  for k in itertools.product((0, 1), repeat=3)])
    c = np.c_[c, np.ones(8)]
    return float(np.linalg.norm((c @ t_a.T - c @ t_b.T)[:, :3],
                                axis=1).max())


def series_pair(root: str):
    """Epochs 1 and 2 of the series in ``root`` and its ground truth."""
    scans = os.path.join(root, "scans")
    files = sorted(os.listdir(scans))
    _, gt = formats.read_ground_truth_transforms(
        os.path.join(root, "defined_transformations.txt"))
    return (scans, read_pcd(os.path.join(scans, files[0])),
            read_pcd(os.path.join(scans, files[1])), gt)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """The reduced rockfall series, written by the port's generator."""
    root = str(tmp_path_factory.mktemp("rockfall"))
    rockfall.generate_rockfall(root, EPOCHS, extent=EXTENT, res=RES)
    return root


def test_series_byte_identical_to_eval(tmp_path):
    """Same arguments and seed: the same scans and ground-truth file, byte
    for byte, as ``eval/rockfall_sim.generate_rockfall``."""
    a, b = str(tmp_path / "eval"), str(tmp_path / "port")
    scans_a = rockfall_sim.generate_rockfall(a, 2, extent=EXTENT, res=RES)
    scans_b = rockfall.generate_rockfall(b, 2, extent=EXTENT, res=RES)
    names = sorted(os.listdir(scans_a))
    assert names == sorted(os.listdir(scans_b))
    assert names == ["SINGLESCANS - 210729_120011.pcd",
                     "SINGLESCANS - 210830_180032.pcd"]
    for name in names:
        assert filecmp.cmp(os.path.join(scans_a, name),
                           os.path.join(scans_b, name), shallow=False)
    assert filecmp.cmp(os.path.join(a, "defined_transformations.txt"),
                       os.path.join(b, "defined_transformations.txt"),
                       shallow=False)


def test_config_is_the_ports_twin():
    """``rockfall_config`` gives the port's configuration with the same
    values as the eval module's."""
    jcfg = rockfall_sim.rockfall_config("s", "o/", kalman_enabled=True)
    cfg = rockfall.rockfall_config("s", "o/", kalman_enabled=True)
    assert type(cfg).__module__ == "piecewise_icp_torch.config"
    assert cfg == config_from_jax(jcfg)


def test_staged_pair_matches_jax(series, monkeypatch):
    """``PWICP_NO_UNIFIED=1``: the staged path (SOR, then segmentation), the
    branch the card takes at the reference's scale, against the JAX
    package's staged branch, within 0.5 mm at the source's box corners."""
    monkeypatch.setenv("PWICP_NO_UNIFIED", "1")
    scans, c1, c2, gt = series_pair(series)
    jcfg, cfg = rockfall_cfgs(scans, series + "/")
    with jax_tpu_branch() as jdraws:
        ref = j_pairwise.register_pair(c1, c2, jcfg,
                                       sor_mult=jcfg.sor_std_mult_pair)
    got = register_pair(c1, c2, cfg, sor_mult=cfg.sor_std_mult_pair,
                        device="cpu")
    assert len(jdraws) == got.guard_draws == 1
    assert corner_gap(got.trans_mat, ref.trans_mat, c2) < 5e-4
    assert np.allclose(np.diag(got.vcm), np.diag(ref.vcm), rtol=1e-3)
    # the scene is hard (changed surface, coarse sampling): the truth is
    # held by the comparison with the JAX package, not by a tight bound
    assert corner_gap(got.trans_mat, np.linalg.inv(gt[1]), c2) < 0.2


def test_campaign_cli_matches_jax(series, tmp_path):
    """Three epochs through the port's ``4d`` command line with the
    timestamped names: the plan, every table, and the chained transforms
    within 0.5 mm at the box corners of the JAX package's ``run_4d``."""
    scans = os.path.join(series, "scans")
    jcfg, _ = rockfall_cfgs(scans, str(tmp_path / "jax") + "/",
                            kalman_enabled=True)
    gt_file = os.path.join(series, "defined_transformations.txt")
    with jax_tpu_branch():
        assert j_run_4d(jcfg, 0, EPOCHS, -1, overlap_thd=0.75,
                        ground_truth=gt_file)
    _, cfg = rockfall_cfgs(scans, str(tmp_path / "port") + "/")
    conf = tmp_path / "config_4d.txt"
    cfg.to_reference_file(conf)
    assert cli_main(["4d", "--config", str(conf), "--epochs", str(EPOCHS),
                     "--mode", "-1", "--kalman", "--device", "cpu",
                     "--epoch-prefix", "- ", "--epoch-digits", "6"]) == 0
    jout, out = tmp_path / "jax", tmp_path / "port"
    for name in ("TransMatrices.txt", "TransParameters.txt",
                 "TransMatrices_toRef.txt", "TransParameters_toRef.txt",
                 "TransPara_AbsError.txt",
                 "TransMatrices_toRef_smoothed.txt",
                 "TransParameters_toRef_smoothed.txt",
                 "TransPara_AbsError_smoothed.txt", "RegPairFile.txt",
                 "phase_timings.jsonl"):
        assert (out / name).exists(), name
    plan = formats.read_reg_pairs(out / "RegPairFile.txt")
    assert plan == formats.read_reg_pairs(jout / "RegPairFile.txt")
    assert plan == {1: 0, 2: 1}      # 2 <- 1, 3 <- 2
    stamps, got, _ = formats.read_trans_matrices(
        out / "TransMatrices_toRef.txt", EPOCHS - 1)
    _, ref, _ = formats.read_trans_matrices(
        jout / "TransMatrices_toRef.txt", EPOCHS - 1)
    # the rows carry the files' timestamps, in time order
    assert stamps == [210830, 210928]
    c = read_pcd(os.path.join(scans, sorted(os.listdir(scans))[-1]))
    for t_got, t_ref in zip(got, ref):
        assert corner_gap(t_got, t_ref, c) < 5e-4
    assert np.isfinite(formats.read_abs_errors(
        out / "TransPara_AbsError.txt")).all()


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_runner_summary_keys(series):
    """``python -m piecewise_icp_torch.utils.rockfall`` on the reduced
    series: the summary it prints and writes has the keys of
    ``eval/rockfall_report.json``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert rockfall.main(["--workdir", series, "--epochs", str(EPOCHS),
                              "--extent", *map(str, EXTENT),
                              "--res", str(RES), "--device", "cpu"]) == 0
    printed = json.loads(buf.getvalue().splitlines()[-1])
    with open(os.path.join(series, "rockfall_report.json")) as f:
        written = json.load(f)
    with open(EVAL / "rockfall_report.json") as f:
        want = _keys(json.load(f))
    assert _keys(printed) == _keys(written) == want
    assert printed["four_d"]["ok"] is True
    assert printed["pair"]["points"] == [len(read_pcd(os.path.join(
        series, "scans", n))) for n in
        sorted(os.listdir(os.path.join(series, "scans")))[:2]]


def test_runner_defaults_to_the_card(tmp_path):
    """Like every entry point of the port, the runner runs on the card
    unless told otherwise, and raises where no GPU is visible."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    with pytest.raises(RuntimeError, match="is_available"):
        rockfall.run_rockfall(str(tmp_path), epochs=2, pair_only=True,
                              extent=EXTENT, res=RES)


@pytest.mark.slow
def test_full_scale_jax_pair_is_the_smoke_constant(tmp_path):
    """The JAX package's transform of the full-scale rockfall pair
    (configuration 3 on epochs 1 and 2 of the 6-epoch series, 150 m x 100 m
    at 0.3 m, seed 7), which ``chip_smoke.py`` holds the card's transform
    against: recomputed here (about 3 min on the CPU) and printed."""
    import chip_smoke

    root = str(tmp_path)
    rockfall.generate_rockfall(root, chip_smoke.ROCKFALL_EPOCHS,
                               seed=chip_smoke.ROCKFALL_SEED,
                               extent=chip_smoke.ROCKFALL_EXTENT,
                               res=chip_smoke.ROCKFALL_RES)
    scans, c1, c2, _ = series_pair(root)
    jcfg = rockfall_sim.rockfall_config(scans, root + "/",
                                        res=chip_smoke.ROCKFALL_RES,
                                        segmentation_impl="jax")
    with jax_tpu_branch():
        ref = j_pairwise.register_pair(c1, c2, jcfg,
                                       sor_mult=jcfg.sor_std_mult_pair)
    print("JAX_ROCKFALL_PAIR", json.dumps(ref.trans_mat.ravel().tolist()))
    assert corner_gap(ref.trans_mat, chip_smoke.JAX_ROCKFALL_PAIR, c2) < 1e-6
