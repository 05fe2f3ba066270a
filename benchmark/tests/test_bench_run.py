"""A whole run of a tiny cell on the CPU, past the look for a card: the
last line has the contract's keys, a sound run is correct, and a run with
its timed path broken underneath is not."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT, make_root

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run_tiny(tmp_path, capsys, traced=False, fault=None, seconds=1.0):
    root = make_root(tmp_path)
    rc = harness.run("tiny.pair_stream", 2**31 + 3, seconds, traced, 0.0,
                     root=root, device="cpu", look_for_chip=False,
                     fault=fault)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


def test_last_line_keys(tmp_path, capsys):
    line, err = run_tiny(tmp_path, capsys)
    assert set(line) == LINE_KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "pair_p90_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"pose_gap_mm", "sigma_gap", "failed"}
    # the numbers compared are the last lines on standard error
    last = err.strip().splitlines()[-3:]
    assert [x.split()[2] for x in last] == ["pose_gap_mm", "sigma_gap",
                                            "failed"]


def test_traced_line(tmp_path, capsys):
    line, _ = run_tiny(tmp_path, capsys, traced=True)
    assert set(line) == LINE_KEYS | {"breakdown"}
    assert list(line)[-1] == "checks"
    # spans are read; on the CPU no device operation exists to read
    assert {"prep_ms.pair", "seg_ms.pair", "core_ms.pair"} <= set(
        line["metrics"])
    assert "kernel_ms.pair" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(entry):
    """A step that returns its state unchanged: the identity transform."""
    inner = entry.request

    def request(k):
        out = inner(k)
        return dict(out, trans_mat=np.eye(4))
    entry.request = request


def _altered(entry):
    """An answer altered where it is produced: the translation moved by
    0.1 mm along x."""
    inner = entry.request

    def request(k):
        out = inner(k)
        t = out["trans_mat"].copy()
        t[0, 3] += 1e-4
        return dict(out, trans_mat=t)
    entry.request = request


def _vcm_scaled(entry):
    """An answer altered where it is produced: the VCM scaled by 1.1."""
    inner = entry.request

    def request(k):
        out = inner(k)
        return dict(out, vcm=out["vcm"] * 1.1)
    entry.request = request


def _raises(entry):
    """A request that never comes: it raises."""
    def request(k):
        raise RuntimeError("broken")
    entry.request = request


@pytest.mark.parametrize("fault", [_unchanged, _altered, _vcm_scaled,
                                   _raises])
def test_broken_timed_path_is_not_correct(tmp_path, capsys, fault):
    line, _ = run_tiny(tmp_path, capsys, fault=fault)
    assert line["correct"] is False


def test_no_card_no_result():
    """Without a CUDA device the command prints no result and fails."""
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "synthetic.pair_stream", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a folder that holds only the manifest and the benchmark, the
    command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "synthetic.pair_stream", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def run_tiny_campaign(tmp_path, capsys, fault=None):
    root = make_root(tmp_path)
    rc = harness.run("tiny.campaign", 2**31 + 9, 1.0, False, 0.0,
                     root=root, device="cpu", look_for_chip=False,
                     fault=fault)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def _plan_altered(entry):
    """The plan altered where it is produced: source 2 planned onto the
    other of its two possible targets."""
    inner = entry.request

    def request(k):
        out = inner(k)
        f = out["out"] / "RegPairFile.txt"
        plan = dict(map(int, ln.split()) for ln in f.read_text().split("\n")
                    if ln.strip())
        f.write_text(f"1 0\n2 {1 - plan[2]}\n")
        return out
    entry.request = request


def _pair_unchanged(entry):
    """A pair that returns its state unchanged: every pair file holds the
    identity."""
    inner = entry.request

    def request(k):
        out = inner(k)
        for f in sorted((out["out"] / "pairs").glob("pair_*.npz")):
            d = dict(np.load(f))
            d["tm"] = np.eye(4)
            np.savez(f, **d)
        return out
    entry.request = request


def test_campaign_run(tmp_path, capsys):
    line = run_tiny_campaign(tmp_path, capsys)
    assert set(line) == LINE_KEYS and line["correct"] is True
    assert set(line["metrics"]) == {"epochs_per_s", "setup_s"}
    assert set(line["checks"]) == {"plan_mismatch", "pose_gap_mm",
                                   "sigma_gap", "failed"}


@pytest.mark.parametrize("fault", [_plan_altered, _pair_unchanged])
def test_broken_campaign_is_not_correct(tmp_path, capsys, fault):
    assert run_tiny_campaign(tmp_path, capsys, fault)["correct"] is False
