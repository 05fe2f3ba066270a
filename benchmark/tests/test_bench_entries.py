"""Request kinds are found by name: every mix's ``entry`` is a module of
``benchmark/entries/``, an unknown one stops the run before anything is
measured, and a kind that only a test registers runs a tiny cell."""

import json
import pathlib

import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT, add_cell, make_root

MIXES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob(
    "*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_every_mix_finds_its_kind(mix):
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json")
                         .read_text())
    path = ROOT / "benchmark" / "entries" / f"{traffic['entry']}.py"
    assert path.is_file(), path
    cell = next(w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["traffic"] == mix)
    kind = harness.Cell(cell).kind()
    assert pathlib.Path(kind.__file__).resolve() == path
    for attr in ("ENTRY", "JUDGE", "CHECKS", "CONTROL"):
        assert hasattr(kind, attr), attr


@pytest.mark.parametrize("entry", ["no_such_kind", "pair.x", "../pair"])
def test_unknown_kind_no_result(tmp_path, capsys, entry):
    root = make_root(tmp_path)
    add_cell(root, "tiny.unknown", "unknown", {"entry": entry},
             {"pose_gap_mm": 1.0}, "pairs_per_s")
    rc = harness.run("tiny.unknown", 1, 1.0, False, 0.0, root=root,
                     device="cpu", look_for_chip=False)
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert repr(entry) in err


def test_kind_registered_by_a_test_runs(tmp_path, capsys, kinds):
    root = make_root(tmp_path)
    add_cell(root, "tiny.backward", "backward",
             {"entry": "tiny_pairs", "checked_pairs": 2},
             {"pose_gap_mm": 1e-6, "sigma_gap": 1e-6}, "pairs_per_s")
    assert not (ROOT / "benchmark" / "entries" / "tiny_pairs.py").exists()
    rc = harness.run("tiny.backward", 2**31 + 21, 1.0, False, 0.0,
                     root=root, device="cpu", look_for_chip=False)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}
    assert set(line["checks"]) == {"pose_gap_mm", "sigma_gap", "failed"}
