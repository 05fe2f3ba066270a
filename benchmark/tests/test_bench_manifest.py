"""The manifest keeps to the contract, and every cell finds its
configuration, mix, metric readers and limits by name; added files alone
bring a new configuration, mix and metric in."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert "bound" not in m
        assert m["moves"] in [e["name"] for e in MANIFEST["end_to_end"]]
    for thing in (MANIFEST["configs"] + MANIFEST["workloads"]
                  + MANIFEST["end_to_end"] + MANIFEST["per_layer"]):
        assert NAME.match(thing["name"])
        if "unit" in thing:
            assert UNIT.match(thing["unit"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["entry"] in ("pair", "campaign")
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert any(m["name"] != "setup_s" for m in c.end_to_end)
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    expected = {"pose_gap_mm", "sigma_gap"}
    if c.traffic["entry"] == "campaign":
        expected.add("plan_mismatch")
    assert set(c.limits["limits"]) == expected
    for m in c.per_layer:
        assert any(e["name"] == m["moves"] for e in c.end_to_end)


def test_added_files_are_taken_up(tmp_path):
    root = make_root(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "tiny2.json").write_text(
        (bench / "configs" / "tiny.json").read_text().replace(
            '"tiny"', '"tiny2"'))
    (bench / "traffic" / "pair_twice.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "pair_stream.json")
                        .read_text()), checked_pairs=2)))
    (bench / "metrics" / "pairs_per_min.py").write_text(
        "def read(ctx):\n    return 60.0 * len(ctx.done)\n")
    (bench / "limits" / "tiny2.pair_twice.json").write_text(
        json.dumps({"limits": {"pose_gap_mm": 1.0, "sigma_gap": 1.0}}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny2", "source": "test",
                                "file": "benchmark/configs/tiny2.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny2.pair_twice",
                                  "config": "tiny2", "traffic": "pair_twice",
                                  "chips": 1, "why": "test"})
    manifest["end_to_end"].append({"name": "pairs_per_min", "unit": "1/min",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["tiny2.pair_twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell("tiny2.pair_twice", root)
    assert cell.config["name"] == "tiny2"
    assert cell.traffic["checked_pairs"] == 2
    names = [m["name"] for m in cell.end_to_end]
    assert "pairs_per_min" in names and "setup_s" in names
    ctx = harness.Context(cell, 1.0, 0.0, [
        {"start": 0.0, "end": 1.0, "ok": True, "units": 1}])
    assert cell.reader("pairs_per_min")(ctx) == 60.0
    assert "pairs_per_min" not in [
        m["name"] for m in harness.Cell("tiny.pair_stream", root).end_to_end]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such_cell")
