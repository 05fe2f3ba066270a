"""PyTorch port, the pair path's surroundings: the colored-PCD writers
against the JAX package's byte for byte, ``isVisual`` through the file
entry point, the ``PWICP_NO_UNIFIED`` and ``PWICP_PROFILE_DIR`` hooks of
``register_pair``, the drop-in C ABI (ctypes, the reference's calling
convention), a cloud that cannot be read, and ``adaptive_pair_sequence``'s
``batch_window``."""

import ctypes
import json
import os

import numpy as np
import pytest

from piecewise_icp_tpu.utils import viz as jviz

from piecewise_icp_torch import native
from piecewise_icp_torch.config import config_from_jax
from piecewise_icp_torch.io import formats, read_pcd, write_pcd
from piecewise_icp_torch.models import pairwise
from piecewise_icp_torch.models.four_d import adaptive_pair_sequence
from piecewise_icp_torch.ops.transform import apply_transform_np
from piecewise_icp_torch.utils import viz
from piecewise_icp_torch.utils.synth import make_series

from util import make_pair, small_test_config

PARAMS = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
VIEWS = ("Patches1_colored.pcd", "Patches2_colored.pcd",
         "StableUnstable2.pcd", "ThreeClouds.pcd")


def _writer_args(rng):
    a = rng.normal(size=(500, 3)).astype(np.float32)
    b = rng.normal(size=(300, 3)).astype(np.float32)
    return {
        "export_colored_patches": (
            a, rng.integers(-1, 7, size=500).astype(np.int32)),
        "export_stable_unstable": (a, rng.uniform(size=500) > 0.4),
        "export_cloud_pair": (a, b),
        "export_three_clouds": (a, b, b + np.float32(0.01)),
    }


@pytest.mark.parametrize("writer", ["export_colored_patches",
                                    "export_stable_unstable",
                                    "export_cloud_pair",
                                    "export_three_clouds"])
def test_viz_writer_bytes_equal_jax(rng, tmp_path, writer):
    args = _writer_args(rng)[writer]
    getattr(jviz, writer)(tmp_path / "jax.pcd", *args)
    getattr(viz, writer)(tmp_path / "torch.pcd", *args)
    raw = (tmp_path / "torch.pcd").read_bytes()
    assert raw == (tmp_path / "jax.pcd").read_bytes()
    # and the port's reader takes the xyz back
    n = sum(len(x) for x in args if x.ndim == 2)
    np.testing.assert_array_equal(read_pcd(tmp_path / "torch.pcd"),
                                  np.vstack([x for x in args if x.ndim == 2]))
    assert n == len(read_pcd(tmp_path / "torch.pcd"))


def _pair_files(rng, tmp_path, n_side=60, **over):
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=n_side)
    write_pcd(tmp_path / "Epoch_000.pcd", c1)
    write_pcd(tmp_path / "Epoch_001.pcd", c2)
    cfg = small_test_config(path1=str(tmp_path / "Epoch_000.pcd"),
                            path2=str(tmp_path / "Epoch_001.pcd"), **over)
    conf = tmp_path / "config_pair.txt"
    cfg.to_reference_file(conf)
    return conf, c1, c2, t_true


def _truth_max(t_est, t_true, pts) -> float:
    p = pts.astype(np.float64)
    return float(np.linalg.norm(apply_transform_np(p, t_est @ t_true) - p,
                                axis=1).max())


def test_is_visual_writes_the_four_views(rng, tmp_path, monkeypatch):
    conf, c1, c2, _ = _pair_files(rng, tmp_path, visual=True)
    seen = []
    write_viz = pairwise.write_visualizations
    monkeypatch.setattr(pairwise, "write_visualizations",
                        lambda p, r: seen.append(r) or write_viz(p, r))
    prefix = str(tmp_path / "Vis_")
    assert pairwise.piecewise_icp_pair_call(str(conf), prefix, device="cpu")
    assert (tmp_path / "Vis_TransMatrix.txt").exists()
    core = seen[0].core
    want = dict(zip(VIEWS, (len(core.patches1.points),
                            len(core.patches2.points),
                            len(core.patches2.points),
                            len(c1) + 2 * len(c2))))
    for name in VIEWS:
        assert len(read_pcd(tmp_path / f"Vis_{name}")) == want[name], name


def test_no_unified_takes_the_staged_path(rng, monkeypatch):
    """4,900-point clouds, above the unified path's floor: with
    ``PWICP_NO_UNIFIED`` set, both clouds take the staged path."""
    c1, c2, t_true = make_pair(rng, PARAMS, n_side=70)
    calls = {"unified": 0, "staged": 0}
    unified, staged = (pairwise.preprocess_segment_device,
                       pairwise.preprocess_cloud)

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pairwise, "preprocess_segment_device",
                        count("unified", unified))
    monkeypatch.setattr(pairwise, "preprocess_cloud", count("staged", staged))
    cfg = config_from_jax(small_test_config(guard_enabled=False))
    pairwise.register_pair(c1, c2, cfg, device="cpu")
    assert calls == {"unified": 2, "staged": 0}
    monkeypatch.setenv("PWICP_NO_UNIFIED", "1")
    calls.update(unified=0, staged=0)
    res = pairwise.register_pair(c1, c2, cfg, device="cpu")
    assert calls == {"unified": 0, "staged": 2}
    assert _truth_max(res.trans_mat, t_true, c2) < 5e-3


def test_profile_dir_writes_a_trace(rng, tmp_path, monkeypatch):
    c1, c2, _ = make_pair(rng, PARAMS, n_side=60)
    monkeypatch.setenv("PWICP_PROFILE_DIR", str(tmp_path / "trace"))
    pairwise.register_pair(c1, c2, config_from_jax(small_test_config(
        guard_enabled=False)), device="cpu")
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.fixture(scope="module")
def dll():
    try:
        path = native.build_capi()
    except native.NativeBuildError as e:
        pytest.skip(f"capi build unavailable: {e}")
    lib = ctypes.cdll.LoadLibrary(path)
    # the reference's exact signature declarations (python/main.py:15-18)
    lib.PiecewiseICP_pair_call.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PiecewiseICP_pair_call.restype = ctypes.c_bool
    lib.PiecewiseICP_4D_call.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]
    lib.PiecewiseICP_4D_call.restype = ctypes.c_bool
    return lib


def test_capi_missing_config_returns_false(dll, monkeypatch, tmp_path):
    monkeypatch.setenv("PWICP_TORCH_DEVICE", "cpu")
    assert dll.PiecewiseICP_pair_call(b"/no/such/config.txt",
                                      str(tmp_path).encode()) is False
    assert dll.PiecewiseICP_4D_call(b"/no/such/config.txt", 0, 3, -1,
                                    0.75) is False


def test_capi_pair_call_end_to_end(dll, rng, tmp_path, monkeypatch):
    """``PWICP_TORCH_DEVICE=cpu``: the C symbol registers the pair on the
    CPU and writes the reference's report."""
    monkeypatch.setenv("PWICP_TORCH_DEVICE", "cpu")
    conf, _, c2, t_true = _pair_files(rng, tmp_path)
    out = str(tmp_path) + os.sep
    assert dll.PiecewiseICP_pair_call(str(conf).encode(), out.encode()) \
        is True
    rep = formats.read_trans_matrix_report(tmp_path / "TransMatrix.txt")
    assert _truth_max(rep["trans_mat"], t_true, c2) < 5e-3
    assert (tmp_path / "RegisteredSourceCloud.pcd").exists()


def test_unreadable_cloud_returns_false(rng, tmp_path):
    """A malformed PCD whose reader raises something other than the
    package's own errors (an IndexError here) is a failed call."""
    conf, _, _, _ = _pair_files(rng, tmp_path)
    (tmp_path / "Epoch_001.pcd").write_text(
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        "WIDTH 1\nHEIGHT 1\nPOINTS\nDATA ascii\n1 2 3\n")
    with pytest.raises(IndexError):
        read_pcd(tmp_path / "Epoch_001.pcd")
    assert pairwise.piecewise_icp_pair_call(
        str(conf), str(tmp_path / "out_"), device="cpu") is False
    assert not (tmp_path / "out_TransMatrix.txt").exists()


def test_batch_window_keeps_the_plan(tmp_path):
    """``batch_window`` is accepted as in the JAX package and changes
    nothing: the scan is sequential."""
    epochs, _ = make_series(np.random.default_rng(3), 4, trend=(0, 0, 0.02),
                            n_side=40)
    files = []
    for k, e in enumerate(epochs):
        files.append(str(tmp_path / f"Epoch_{k + 1:03d}.pcd"))
        write_pcd(files[-1], e)
    plain = adaptive_pair_sequence(files, 0, 0.05, 0.75, device="cpu")
    windowed = adaptive_pair_sequence(files, 0, 0.05, 0.75, batch_window=2,
                                      device="cpu")
    assert windowed == plain
    assert len(plain[0]) == 3
