"""PyTorch port, the span tree of ``utils/logging.py``: span records with
ids, parents, requests, threads and ``time.time_ns()`` bounds, exclusive
counters, threads apart, the bounded buffer, the pair's and the campaign's
phases as spans, the re-read of a rewritten PCD file, and profiler ranges
only where asked for.  One test, marked ``cuda``, holds the counted syncs
of a pair on the card against ``torch.cuda.set_sync_debug_mode``."""

import collections
import contextlib
import json
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from piecewise_icp_torch.config import PiecewiseICPConfig
from piecewise_icp_torch.io import write_pcd
from piecewise_icp_torch.models import four_d
from piecewise_icp_torch.models.pairwise import register_pair
from piecewise_icp_torch.utils import logging as plog
from piecewise_icp_torch.utils.logging import (GLOBAL_TIMER, SpanTimer,
                                               annotated_spans, gphase,
                                               note_sync, to_device, to_host)
from piecewise_icp_torch.utils.synth import make_pair, make_series

PARAMS = [0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005]
SETTINGS = dict(set_res_svsize=True, res1=0.022, res2=0.022, svsize1=0.22,
                svsize2=0.22, set_dtinit=True, dt_init=0.05, dt_min=0.004,
                guard_enabled=False)
FIELDS = {"phase", "seconds", "id", "parent", "request", "thread",
          "start_ns", "end_ns", "counts"}


def _by_id(records):
    return {r["id"]: r for r in records}


def _assert_tree(records):
    """Every parent is an open span of the same thread and request that
    holds its child's interval."""
    by_id = _by_id(records)
    for r in records:
        assert FIELDS <= set(r), r
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is None:
            assert r["request"] == r["id"]
            continue
        p = by_id[r["parent"]]
        assert p["thread"] == r["thread"] and p["request"] == r["request"]
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]


def test_nested_span_records():
    t = SpanTimer()
    before = time.time_ns()
    with t.phase("outer", step=3):
        with t.phase("inner"):
            pass
        with t.phase("inner2"):
            pass
    after = time.time_ns()
    inner, inner2, outer = t.records
    assert [r["phase"] for r in t.records] == ["inner", "inner2", "outer"]
    assert outer["step"] == 3 and outer["parent"] is None
    assert outer["request"] == outer["id"]
    for r in (inner, inner2):
        assert r["parent"] == outer["id"] and r["request"] == outer["id"]
    assert len({r["id"] for r in t.records}) == 3
    assert {r["thread"] for r in t.records} == {
        threading.current_thread().name}
    assert before <= outer["start_ns"] <= inner["start_ns"] \
        <= inner["end_ns"] <= inner2["start_ns"] <= inner2["end_ns"] \
        <= outer["end_ns"] <= after
    assert 0 <= inner["seconds"] <= outer["seconds"]
    _assert_tree(t.records)


def test_counts_are_exclusive():
    t = SpanTimer()
    t.count(syncs=5)                    # no span open: not recorded
    with t.phase("a"):
        t.count(syncs=1)
        with t.phase("b"):
            t.count(syncs=2, h2d=1, h2d_bytes=0)
            t.count(h2d_bytes=12)
        t.count(syncs=1)
    with t.phase("c"):
        pass
    b, a, c = t.records
    assert b["counts"] == {"syncs": 2, "h2d": 1, "h2d_bytes": 12}
    assert a["counts"] == {"syncs": 2}
    assert c["counts"] == {}


def test_helpers_count_the_card_only():
    GLOBAL_TIMER.records.clear()
    with gphase("probe"):
        x = to_device(np.arange(4, dtype=np.float32), "cpu")
        y = to_host(x + 1)
        note_sync(y)
        to_device(2.5, "cpu", torch.float64)
        GLOBAL_TIMER.count(syncs=3)
    (rec,) = GLOBAL_TIMER.records
    assert rec["counts"] == {"syncs": 3}
    assert y.tolist() == [1.0, 2.0, 3.0, 4.0]
    assert to_device(True, "cpu").dtype == torch.bool
    assert to_device([1, 2], "cpu").dtype == torch.int64


def test_threads_never_parent_each_other():
    """More threads than cores open nested spans and count at once, with
    a short switch interval: each record's parent and request are its own
    thread's, ids are unique, and no count is lost."""
    t = SpanTimer()
    n_threads, loops = 2 * (os.cpu_count() or 4), 150
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(timeout=30)
        for _ in range(loops):
            with t.phase(f"outer{k}"):
                t.count(syncs=1)
                with t.phase(f"inner{k}"):
                    t.count(syncs=k + 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), name=f"w{k}")
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = list(t.records)
    assert len(recs) == n_threads * loops * 2
    assert len({r["id"] for r in recs}) == len(recs)
    _assert_tree(recs)
    for k in range(n_threads):
        mine = [r for r in recs if r["thread"] == f"w{k}"]
        assert {r["phase"] for r in mine} == {f"outer{k}", f"inner{k}"}
        assert sum(r["counts"]["syncs"] for r in mine) == loops * (k + 2)


def test_bounded_buffer_keeps_the_newest():
    t = SpanTimer(maxlen=5)
    for k in range(12):
        with t.phase(f"s{k}"):
            pass
    assert [r["phase"] for r in t.records] == [f"s{k}" for k in range(7, 12)]
    t.records.clear()
    assert len(t.records) == 0
    assert GLOBAL_TIMER.records.maxlen == plog.SPAN_RECORDS


def test_profiler_ranges_only_when_annotated():
    from torch.profiler import ProfilerActivity, profile

    def names(annotate):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with annotated_spans() if annotate else \
                    contextlib.nullcontext():
                with gphase("trace.probe"):
                    torch.ones(3).add_(1)
        return {e.name for e in prof.events()}

    assert "trace.probe" not in names(False)
    assert "trace.probe" in names(True)
    assert GLOBAL_TIMER.annotate == 0


def test_pair_phases_are_spans():
    rng = np.random.default_rng(0)
    c1, c2, _ = make_pair(rng, PARAMS, n_side=70)
    cfg = PiecewiseICPConfig(**SETTINGS).validate()
    GLOBAL_TIMER.records.clear()
    out = register_pair(c1, c2, cfg, device="cpu")
    assert [r["phase"] for r in out.timer.records] == [
        "target", "resolution", "preprocess", "core"]
    recs = list(GLOBAL_TIMER.records)
    _assert_tree(recs)
    by_id = _by_id(recs)
    (pair,) = [r for r in recs if r["phase"] == "pair"]
    assert pair["parent"] is None
    assert all(r["request"] == pair["id"] for r in recs)
    phases = {r["phase"]: r for r in recs if r["parent"] == pair["id"]}
    assert set(phases) == {"pair.target", "pair.resolution",
                           "pair.preprocess", "pair.core"}
    names = collections.Counter(r["phase"] for r in recs)
    assert names["core.iteration"] >= 1
    assert names["seg.fused.patches"] == names["seg.fused"] == 2
    for r in recs:
        # a new span of the prep, seg and core layers nests in its layer
        if r["phase"].startswith("seg.fused."):
            assert by_id[r["parent"]]["phase"] == "seg.fused"
        if r["phase"].split(".")[0] in ("prep", "seg", "core"):
            assert by_id[r["parent"]]["phase"].split(".")[0] in (
                "pair", "prep", "seg", "core")


def _campaign(tmp_path, n_epochs=3):
    rng = np.random.default_rng(5)
    epochs, _ = make_series(rng, n_epochs, trend=(0.0, 0.0, 0.02),
                            n_side=60)
    scans = tmp_path / "scans"
    scans.mkdir()
    for k, e in enumerate(epochs):
        write_pcd(scans / f"Epoch_{k + 1:03d}.pcd", e)
    cfg = PiecewiseICPConfig(**SETTINGS, path1=str(scans),
                             path2=str(tmp_path / "out") + os.sep).validate()
    conf = tmp_path / "config.txt"
    cfg.to_reference_file(conf)
    return conf, epochs


def test_campaign_phases_are_spans(tmp_path):
    conf, epochs = _campaign(tmp_path)
    GLOBAL_TIMER.records.clear()
    assert four_d.piecewise_icp_4d_call(
        str(conf), 0, len(epochs), -1, 0.75, device="cpu",
        guard_enabled=False, kalman_enabled=True)
    recs = list(GLOBAL_TIMER.records)
    _assert_tree(recs)
    by_id = _by_id(recs)
    (camp,) = [r for r in recs if r["phase"] == "campaign"]
    mine = [r for r in recs if r["request"] == camp["id"]]
    children = collections.Counter(
        r["phase"] for r in mine if r["parent"] == camp["id"])
    for name in ("campaign.pair_planning", "campaign.pair",
                 "campaign.chaining", "campaign.kalman", "campaign.tables",
                 "io.write_pair"):
        assert children[name] >= 1, (name, children)
    assert children["campaign.pair"] == len(epochs) - 1
    pairs = [r for r in mine if r["phase"] == "campaign.pair"]
    assert sorted(r["step"] for r in pairs) == [1, 2]
    assert all(by_id[r["parent"]]["phase"] == "campaign.pair"
               for r in recs if r["phase"] == "pair")
    reads = [r for r in recs if r["phase"] == "io.read_pcd"]
    assert all(r["bytes"] > 0 for r in reads) and reads
    assert any(r["phase"] == "plan.grid" for r in mine)
    # every epoch prepared once, inline or on the prefetch thread, whose
    # spans are a request of their own
    prep = [r for r in recs if r["phase"] == "campaign.prepare"]
    assert sorted(r["epoch"] for r in prep) == list(range(len(epochs)))
    for r in prep:
        if r["thread"] != camp["thread"]:
            assert r["thread"].startswith("prefetch")
            assert r["parent"] is None and r["request"] == r["id"]
    waits = [r for r in mine if r["phase"] == "campaign.prefetch_wait"]
    assert all(by_id[r["parent"]]["phase"] == "campaign" for r in waits)
    assert all(r["thread"] == camp["thread"] for r in mine)
    # the campaign's own file keeps its phases and gains the tables
    rows = [json.loads(ln) for ln in
            (tmp_path / "out" / "phase_timings.jsonl").read_text()
            .splitlines()]
    assert collections.Counter(r["phase"] for r in rows) == {
        "pair_planning": 1, "pair": 2, "chaining": 1, "kalman": 1,
        "tables": 1}
    assert all(set(r) <= {"phase", "seconds", "step"} for r in rows)


def test_rewritten_pcd_is_read_again(tmp_path):
    path = tmp_path / "Epoch_001.pcd"
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    write_pcd(path, a)
    sizes = [path.stat().st_size]
    GLOBAL_TIMER.records.clear()
    np.testing.assert_array_equal(four_d._load_cloud_cached(str(path)), a)
    np.testing.assert_array_equal(four_d._load_cloud_cached(str(path)), a)
    b = a[:7] + 1.0
    write_pcd(path, b)
    sizes.append(path.stat().st_size)
    np.testing.assert_array_equal(four_d._load_cloud_cached(str(path)), b)
    # same size, a later modification time
    c = b + 1.0
    write_pcd(path, c)
    st = path.stat()
    sizes.append(st.st_size)
    assert sizes[2] == sizes[1]
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**6))
    np.testing.assert_array_equal(four_d._load_cloud_cached(str(path)), c)
    reads = [r for r in GLOBAL_TIMER.records if r["phase"] == "io.read_pcd"]
    assert [r["bytes"] for r in reads] == sizes


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["unified", "staged", "auto_dtinit"])
def test_syncs_on_the_card_counted_once(monkeypatch, path):
    """One test-size pair on the card under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising call
    PyTorch reports, plus every explicit ``torch.cuda.synchronize`` (which
    the debug mode does not report), is one count of ``syncs`` in the span
    records, and no count is made where PyTorch saw none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counters count the card")
    rng = np.random.default_rng(11)
    c1, c2, _ = make_pair(rng, PARAMS, n_side=150)
    settings = dict(SETTINGS, res1=0.015, res2=0.015, svsize1=0.15,
                    svsize2=0.15)
    if path == "auto_dtinit":
        settings["set_dtinit"] = False
    if path == "staged":
        monkeypatch.setenv("PWICP_NO_UNIFIED", "1")
    cfg = PiecewiseICPConfig(**settings).validate()
    register_pair(c1, c2, cfg, device="cuda")      # build, lazy init
    torch.cuda.synchronize()

    explicit = [0]
    real = torch.cuda.synchronize

    def counted(*a, **k):
        explicit[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    GLOBAL_TIMER.records.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            register_pair(c1, c2, cfg, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught if "called a synchronizing CUDA operation"
              in str(w.message)]
    recs = list(GLOBAL_TIMER.records)
    syncs = sum(r["counts"].get("syncs", 0) for r in recs)
    h2d = sum(r["counts"].get("h2d", 0) for r in recs)
    where = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in warned)
    by_span = collections.Counter()
    for r in recs:
        by_span[r["phase"]] += r["counts"].get("syncs", 0)
    assert syncs == len(warned) + explicit[0], (
        f"counted {syncs}, warned {len(warned)}, explicit {explicit[0]}; "
        f"warned at {dict(where)}; counted by span {dict(by_span)}")
    assert 0 < h2d <= syncs
    assert all(r["counts"].get("h2d_bytes", 0) > 0 for r in recs
               if r["counts"].get("h2d"))
