"""A tiny copy of the benchmark's data files for the CPU tests: one
configuration of three 3,600-point synthetic epochs (the staged path, the
acceptance guard off so a pair takes seconds on the CPU) under the
benchmark's own mixes, metrics and the manifest's metric list."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

TINY_CONFIG = {
    "name": "tiny",
    "source": "test",
    "settings": {"set_res_svsize": True, "res1": 0.022, "res2": 0.022,
                 "svsize1": 0.22, "svsize2": 0.22, "set_dtinit": True,
                 "dt_init": 0.05, "dt_min": 0.004, "guard_enabled": False,
                 "kalman_enabled": True},
    "campaign": {"pair_mode": -1, "overlap_threshold": 0.75},
    "generator": {"module": "synth",
                  "args": {"n_epochs": 3, "n_side": 60, "extent": 2.0,
                           "trend": [0.0, 0.0, 0.02]}},
    "reduced": [],
}


def make_root(tmp: pathlib.Path, limits=None) -> pathlib.Path:
    """A root with ``BENCHMARK.json`` and ``benchmark/`` data holding the
    cells ``tiny.pair_stream`` and ``tiny.campaign`` (the latter with the
    metrics of ``synthetic.campaign20``)."""
    bench = tmp / "benchmark"
    for sub in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"}]
    manifest["workloads"] = [
        {"name": "tiny.pair_stream", "config": "tiny",
         "traffic": "pair_stream", "chips": 1, "why": "test"},
        {"name": "tiny.campaign", "config": "tiny",
         "traffic": "campaign", "chips": 1, "why": "test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [
                {"synthetic.pair_stream": "tiny.pair_stream",
                 "synthetic.campaign20": "tiny.campaign"}[w]
                for w in m["workloads"]
                if w in ("synthetic.pair_stream", "synthetic.campaign20")]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    lim = limits or {"pose_gap_mm": 1e-6, "sigma_gap": 1e-6}
    (bench / "limits" / "tiny.pair_stream.json").write_text(
        json.dumps({"limits": lim}))
    (bench / "limits" / "tiny.campaign.json").write_text(
        json.dumps({"limits": dict(lim, plan_mismatch=0)}))
    (tmp / "piecewise_icp_torch").symlink_to(ROOT / "piecewise_icp_torch")
    return tmp


def add_cell(root: pathlib.Path, name: str, mix: str, traffic: dict,
             limits: dict, rate: str, readers=None, chips: int = 1) -> None:
    """Add the cell ``name`` of the tiny configuration under the mix
    ``mix`` (``traffic/<mix>.json``, written from ``traffic``), with its
    ``limits``, reporting the end-to-end metric ``rate`` besides ``setup_s``
    and, in its traced run, the per-layer metrics of ``readers``: {metric:
    the source of ``metrics/<metric>.py``}, each in ``count`` and moving
    ``rate``."""
    bench = root / "benchmark"
    (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    (bench / "limits" / f"{name}.json").write_text(
        json.dumps({"limits": limits}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": mix, "chips": chips,
                                  "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == rate:
            m["workloads"].append(name)
    for metric, source in (readers or {}).items():
        (bench / "metrics" / f"{metric}.py").write_text(source)
        manifest["per_layer"].append({
            "name": metric, "unit": "count", "better": "higher",
            "source": "program_span", "layer": "test", "moves": rate,
            "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
