"""PyTorch port, the binding of the CUDA kernels, held on the CPU: the
ctypes signature table against the ``extern "C"`` declarations of the
sources (a wrong entry cuts a pointer to 32 bits, and only on the card),
and every wrapper hands the device of its operands to the launch."""

import ctypes
import re

import numpy as np
import pytest
import torch

from piecewise_icp_torch.ops import _cuda, nn_cuda, seg_cuda
from piecewise_icp_torch.ops.grid_nn import CellGrid, build_grid

from util import terrain_cloud

_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _declarations():
    """{entry name: [ctypes type of each parameter]} of every ``extern "C"``
    function of the kernel sources."""
    found = {}
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        for name, params in _DECL.findall(src.read_text()):
            types = []
            for prm in filter(None, (q.strip() for q in params.split(","))):
                if "*" in prm:
                    types.append(ctypes.c_void_p)
                else:
                    words = prm.split()[:-1]
                    types.append({"int": ctypes.c_int,
                                  "float": ctypes.c_float}[words[-1]])
            assert name not in found, f"{name} declared twice"
            found[name] = types
    return found


def test_every_entry_has_a_signature():
    assert set(_declarations()) == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_signature_matches_declaration(name):
    """Same arity (the stream is the last pointer), ``c_void_p`` for every
    pointer, ``c_int`` / ``c_float`` for the scalars."""
    declared = _declarations()[name]
    assert _cuda._SIGNATURES[name] == declared
    launched = not name.endswith(("_cap", "_tile", "_ctrl"))
    if launched:
        assert declared[-1] is ctypes.c_void_p      # the stream


@pytest.fixture()
def recorded(monkeypatch):
    """A CPU grid whose wrappers believe they are on the card: operand
    checks pass and launches are recorded instead of made."""
    calls = []

    class _Lib:
        @staticmethod
        def pwicp_nn1_tile():
            return 2048

        @staticmethod
        def pwicp_propagate_ctrl(max_rounds):
            return 2 + 4 * max_rounds

    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: _Lib)
    monkeypatch.setattr(
        _cuda, "launch",
        lambda name, counters, *args, device: calls.append(
            (name, counters, device)))
    pts = terrain_cloud(np.random.default_rng(0), n_side=20)
    grid = CellGrid.from_index(build_grid(pts, 0.3), torch.device("cpu"))
    return grid, calls


@pytest.mark.parametrize("entry", ["pwicp_range_nn1", "pwicp_knn_sorted",
                                   "pwicp_nn1_brute", "pwicp_seg_stats",
                                   "pwicp_prop_round", "pwicp_propagate"])
def test_wrapper_passes_its_device_to_launch(recorded, entry):
    grid, calls = recorded
    n = grid.n
    qm = torch.ones(n, dtype=torch.bool)
    f = torch.zeros(n, dtype=torch.float32)
    rows = torch.zeros((n, 8), dtype=torch.float32)
    counters = entry[len("pwicp_"):]
    if entry == "pwicp_range_nn1":
        nn_cuda._range_nn1_kernel(grid.points, qm, grid)
    elif entry == "pwicp_knn_sorted":
        nn_cuda._knn_sorted_kernel(grid, qm, 3)
    elif entry == "pwicp_nn1_brute":
        nn_cuda._nn1_brute_kernel(grid.points, grid.points, qm, qm)
    elif entry == "pwicp_seg_stats":
        seg_cuda._seg_stats_kernel(grid, qm, 5)
    elif entry == "pwicp_prop_round":
        seg_cuda._prop_round_kernel(grid, rows, qm, rows, 1.0, 1.0, False)
    else:
        seg_cuda._propagate_kernel(grid, grid.points, f, qm,
                                   torch.arange(0, n, 7), 0.1, 4)
        counters = ("prop_round", "propagate")
    assert calls == [(entry, counters, grid.points.device)]


def test_sweep_patches_one_constant(tmp_path, monkeypatch):
    """``chip_smoke.py --sweep`` builds its variants from a copy of the
    sources with named constants replaced: once each, and an unknown name
    stops it."""
    monkeypatch.syspath_prepend(str(_cuda.CSRC.parent.parent))
    import chip_smoke

    dst = chip_smoke.patched_sources("kSegCap=256,kPropWarps=8", tmp_path)
    assert "constexpr int kSegCap = 256;" in (dst / "seg_stats.cu").read_text()
    assert ("constexpr int kPropWarps = 8;"
            in (dst / "prop_round.cu").read_text())
    assert ((dst / "knn_sorted.cu").read_text()
            == (_cuda.CSRC / "knn_sorted.cu").read_text())
    with pytest.raises(SystemExit):
        chip_smoke.patched_sources("kNoSuchConstant=1", tmp_path / "other")
