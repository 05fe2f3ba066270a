"""The readers of the program's span records and counters: a traced tiny
run's line holds them (on the CPU nothing is counted, so the counts read
0), and a program whose records carry no counts or starts (a parent
commit's) gives None, not an error."""

import json

import pytest

from benchmark import harness
from benchmark.tests.tiny import make_root

PAIR = ("host_syncs.pair", "h2d_copies.pair", "h2d_mb.pair")
CAMPAIGN = ("host_syncs.campaign", "io_s.campaign",
            "prefetch_wait_s.campaign")


def _traced(tmp_path, capsys, cell, seed):
    root = make_root(tmp_path)
    rc = harness.run(cell, seed, 1.0, True, 0.0, root=root, device="cpu",
                     look_for_chip=False)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def test_traced_pair_line_holds_the_counters(tmp_path, capsys):
    line = _traced(tmp_path, capsys, "tiny.pair_stream", 2**31 + 5)
    for name in PAIR:
        assert line["metrics"][name]["value"] == 0, name
    assert line["metrics"]["h2d_mb.pair"]["unit"] == "MB"


def test_traced_campaign_line_holds_the_campaign_metrics(tmp_path, capsys):
    line = _traced(tmp_path, capsys, "tiny.campaign", 2**31 + 11)
    m = line["metrics"]
    assert m["host_syncs.campaign"]["value"] == 0
    assert m["io_s.campaign"]["value"] > 0          # the PCD reads
    assert m["prefetch_wait_s.campaign"]["value"] >= 0
    assert set(CAMPAIGN) <= set(m)


def _ctx(records, units=2):
    cell = harness.Cell("synthetic.campaign20")
    ctx = harness.Context(cell, 1.0, 0.0, [
        {"start": 0.0, "end": 1.0, "ok": True, "units": units}])
    ctx.traced = True
    ctx.window_ns = (100, 200)
    return cell, ctx


def _new(phase, start, end, **counts):
    return {"phase": phase, "seconds": (end - start) * 1e-9, "id": start,
            "parent": None, "request": start, "thread": "MainThread",
            "start_ns": start, "end_ns": end, "counts": counts}


@pytest.mark.parametrize("name", PAIR + CAMPAIGN)
def test_reader_of_a_parent_program_gives_none(monkeypatch, name):
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    # what the benchmark's stamping makes of a parent's records
    old = [{"phase": "pair", "seconds": 5e-8, "end_ns": 150},
           {"phase": "io.read_pcd", "seconds": 1e-8, "end_ns": 160}]
    monkeypatch.setattr(GLOBAL_TIMER, "records", old)
    cell, ctx = _ctx(old)
    assert cell.reader(name)(ctx) is None
    ctx.traced = False
    monkeypatch.setattr(GLOBAL_TIMER, "records",
                        [_new("pair", 120, 180, syncs=3)])
    assert cell.reader(name)(ctx) is None


def test_readers_sum_in_the_window(monkeypatch):
    from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

    recs = [_new("pair", 110, 190, syncs=3, h2d=2, h2d_bytes=4_000_000),
            _new("core.iteration", 120, 130, syncs=5),
            _new("io.read_pcd", 140, 160),
            _new("io.write_pair", 150, 170),
            _new("campaign.prefetch_wait", 171, 181),
            _new("pair", 10, 50, syncs=100, h2d=100),     # before the window
            _new("io.read_pcd", 190, 250)]                # ends after it
    monkeypatch.setattr(GLOBAL_TIMER, "records", recs)
    cell, ctx = _ctx(recs, units=4)
    read = {name: cell.reader(name) for name in PAIR + CAMPAIGN}
    assert read["host_syncs.pair"](ctx) == 8
    assert read["h2d_copies.pair"](ctx) == 2
    assert read["h2d_mb.pair"](ctx) == pytest.approx(4.0)
    assert read["host_syncs.campaign"](ctx) == 2       # 8 over 4 epochs
    assert read["io_s.campaign"](ctx) == pytest.approx(30e-9)
    assert read["prefetch_wait_s.campaign"](ctx) == pytest.approx(10e-9)
