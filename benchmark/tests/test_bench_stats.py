"""The benchmark's arithmetic against hand-worked values."""

import math

import pytest

from benchmark import harness, stats, trace
from benchmark.tests.tiny import ROOT


def test_window_rate():
    # 4 pairs, window opened at 10.0 s, the last pair ended at 12.5 s
    assert stats.window_rate(4, 10.0, 12.5) == pytest.approx(1.6)
    with pytest.raises(ValueError):
        stats.window_rate(1, 3.0, 3.0)


def test_p90_over_all_pairs():
    lat = [0.40, 0.41, 0.39, 0.45, 0.42, 0.50, 0.38, 0.43, 0.44, 0.60]
    # nearest rank: ceil(0.9 * 10) = 9th of the sorted ten = 0.50
    assert stats.percentile(lat, 90) == 0.50
    # 11 values: ceil(9.9) = 10th
    assert stats.percentile(list(range(1, 12)), 90) == 10
    # a failed pair counts as infinitely late
    assert stats.percentile([0.1] * 9 + [math.inf], 90) == 0.1
    assert stats.percentile([0.1] * 8 + [math.inf] * 2, 90) == math.inf


def test_idle_share_from_a_made_up_timeline():
    # window [0, 100]; kernels [10, 20], [15, 30] (overlap), [50, 60] and
    # [95, 120] (cut at the close): busy 20 + 10 + 5 = 35 -> idle 65%
    ops = [(10, 20), (15, 30), (50, 60), (95, 120)]
    assert stats.covered(stats.clip(ops, 0, 100)) == 35
    assert stats.idle_pct(ops, 0, 100) == pytest.approx(65.0)
    assert stats.gaps(ops, 0, 100) == [(0, 10), (30, 50), (60, 95)]


def test_brute_bound():
    # 137,391 x 137,375 x 9 lane instructions at 33.5e12 a second
    assert stats.brute_bound_s([(137391, 137375)]) == pytest.approx(
        137391 * 137375 * 9 / 33.5e12)


def test_breakdown_names_gaps_by_open_span():
    spans = [("pair", 0, 100), ("prep.voxel", 0, 30), ("core.iteration",
                                                      60, 90)]
    ops = [("k1", 30, 40), ("k2", 50, 60), ("k1", 90, 100)]
    b = trace.breakdown(ops, spans, 0, 100)
    assert b["device_ops"] == [["k1", 2e-8], ["k2", 1e-8]]
    # gaps [0, 30] under prep.voxel, [40, 50] under pair, [60, 90] under
    # core.iteration
    assert dict((k, v) for k, v in b["idle_gaps"]) == pytest.approx(
        {"prep.voxel": 3e-8, "core.iteration": 3e-8, "pair": 1e-8})


def test_program_kernels_and_names():
    names = trace.program_kernels(ROOT / "piecewise_icp_torch" / "csrc")
    assert {"range_nn1_kernel", "knn_sorted_kernel", "seg_stats_kernel",
            "propagate_kernel", "nn1_brute_kernel",
            "knn_brute_kernel"} <= names
    assert trace.base_name(
        "void (anonymous namespace)::range_nn1_kernel<4>(Grid, float*)"
    ) == "range_nn1_kernel"
    assert trace.base_name("seg_stats_kernel(Grid, int)") == \
        "seg_stats_kernel"


def test_span_readers():
    ctx = harness.Context(None, 2.0, 0.0, [
        {"start": 0.0, "end": 1.0, "ok": True, "units": 1},
        {"start": 1.0, "end": 2.0, "ok": True, "units": 1}])
    ctx.traced = True
    ctx.spans = [("prep.voxel", 0, 2_000_000), ("prep.sor", 1_000_000,
                                                3_000_000),
                 ("seg.fused", 5_000_000, 9_000_000),
                 ("preparation", 0, 1)]
    # prep.*: the union [0, 3] ms over 2 pairs; "preparation" is not prep
    assert ctx.span_ms_per_request("prep") == pytest.approx(1.5)
    assert ctx.span_ms_per_request("seg") == pytest.approx(2.0)
    assert ctx.span_ms_per_request("core") is None
