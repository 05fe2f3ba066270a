"""One run of one cell: find the cell's configuration, traffic mix,
metrics and limits by name, make the inputs from the seed, set up and warm
the program on the cell's own shapes, measure a closed loop for the
window, judge what it produced against the plain reference, and print the
result's last line.

Everything that belongs to one configuration, mix, metric or cell is a
file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (named by the manifest), ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` returning a number or None) and
``limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import logging
import pathlib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import drive, judge, stats, trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "piecewise_icp_tpu")


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Cell:
    """One entry of ``workloads`` with its configuration, mix, metrics
    and limits, all read from files under ``root``."""

    def __init__(self, name: str, root: pathlib.Path = ROOT):
        self.root = root
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (self.bench / "traffic" / f"{self.entry['traffic']}.json"
             ).read_text())
        self.limits = json.loads(
            (self.bench / "limits" / f"{name}.json").read_text())

        def mine(metric) -> bool:
            return "workloads" not in metric or name in metric["workloads"]

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]

    @property
    def bench(self) -> pathlib.Path:
        return self.root / "benchmark"

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Context:
    """What a metric reader reads: the window's requests and, in the
    traced run, the spans, device operations and program kernels."""

    def __init__(self, cell: Cell, setup_s: float, t_open: float,
                 requests: List[Dict]):
        self.cell = cell
        self.setup_s = setup_s
        self.t_open = t_open
        self.requests = requests
        self.traced = False
        self.spans: list = []
        self.ops: list = []
        self.window_ns = (0, 0)
        self.kernels: set = set()
        self.extra: Dict = {}

    @property
    def done(self) -> List[Dict]:
        return [r for r in self.requests if r["ok"]]

    @property
    def t_last_end(self) -> float:
        return max(r["end"] for r in self.requests)

    def span_ms_per_request(self, prefix: str) -> Optional[float]:
        """Host time covered by the spans named ``prefix`` or
        ``prefix.*``, in ms a completed request; None without spans."""
        iv = [(s, e) for n, s, e in self.spans
              if n == prefix or n.startswith(prefix + ".")]
        if not iv or not self.done:
            return None
        return stats.covered(iv) * 1e-6 / len(self.done)

    def kernel_ops(self, names=None) -> list:
        """The device operations of the program's own kernels (of
        ``names`` alone, where given)."""
        keep = self.kernels if names is None else set(names)
        return [op for op in self.ops if trace.base_name(op[0]) in keep]


def quiet_logs() -> None:
    """Warnings and errors only from the program's and the reference's
    loggers (each sets INFO when its module is first imported)."""
    import piecewise_icp_torch.utils.logging  # noqa: F401
    from .reference.utils import logging as _ref_logging  # noqa: F401

    for name in ("piecewise_icp_torch", "pwicp_reference"):
        logging.getLogger(name).setLevel(logging.WARNING)


def make_inputs(config: dict, seed: int):
    gen = config["generator"]
    mod = importlib.import_module(f"benchmark.generators.{gen['module']}")
    return mod.make(np.random.default_rng(seed % 2**64), **gen["args"])


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, root: pathlib.Path = ROOT, device: str = "cuda",
        look_for_chip: bool = True, fault=None) -> int:
    """One run; returns the exit code.  ``device``, ``look_for_chip`` and
    ``fault`` (a function that takes the entry object and breaks its timed
    path) exist for the benchmark's own tests."""
    cell = Cell(workload, root)
    import torch

    if look_for_chip:
        if not torch.cuda.is_available():
            say("no CUDA device is visible: nothing measured")
            return 2
        if torch.cuda.device_count() < cell.chips:
            say(f"{cell.name} needs {cell.chips} CUDA devices, "
                f"{torch.cuda.device_count()} visible: nothing measured")
            return 2
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    quiet_logs()

    work = pathlib.Path(tempfile.mkdtemp(prefix="pwicp_bench_"))
    try:
        return _run(cell, seed, seconds, traced, t_start, dev, work, fault)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def written_bytes(folder: pathlib.Path) -> int:
    """Bytes of the regular files under ``folder`` (links not followed)."""
    return sum(p.lstat().st_size for p in folder.rglob("*")
               if p.is_file() and not p.is_symlink())


def _run(cell: Cell, seed: int, seconds: float, traced: bool,
         t_start: float, dev, work: pathlib.Path, fault) -> int:
    import torch

    epochs, gt = make_inputs(cell.config, seed)
    if dev.type == "cuda":
        from piecewise_icp_torch.ops import _cuda

        _cuda.lib()                 # build (first run of a checkout), load
    entry_cls = drive.ENTRIES[cell.traffic["entry"]]
    entry = entry_cls(epochs, gt, cell.config, cell.traffic, work, dev,
                      seconds)
    entry.warm()
    if fault is not None:
        fault(entry)

    requests: List[Dict] = []
    answers: List[Dict] = []
    records = None
    prof_ctx = (trace.device_profile(dev.type == "cuda") if traced
                else None)
    if traced:
        from piecewise_icp_torch.utils.logging import GLOBAL_TIMER

        records = trace.stamp_spans(GLOBAL_TIMER)
        prof_out = prof_ctx.__enter__()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_open = time.perf_counter()
    t_open_ns = time.time_ns()
    setup_s = t_open - t_start
    k = 0
    while time.perf_counter() - t_open < seconds:
        t0 = time.perf_counter()
        try:
            out = entry.request(k)
            ok = True
        except Exception:           # a request that raises has failed
            traceback.print_exc()
            out, ok = {"units": 0}, False
        t1 = time.perf_counter()
        requests.append({"k": k, "start": t0, "end": t1, "ok": ok,
                         "units": out["units"] if ok else 0})
        if ok:
            answers.append(out)
        k += 1
    t_close_ns = t_open_ns + int((requests[-1]["end"] - t_open) * 1e9)
    if traced:
        prof_ctx.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    ctx = Context(cell, setup_s, t_open, requests)
    if traced:
        ctx.traced = True
        ctx.window_ns = (t_open_ns, t_close_ns)
        ctx.spans = trace.span_intervals(records, t_open_ns, t_close_ns)
        ctx.ops = [(n, max(s, t_open_ns), min(e, t_close_ns))
                   for n, s, e in prof_out["ops"]
                   if min(e, t_close_ns) > max(s, t_open_ns)]
        ctx.kernels = trace.program_kernels(
            cell.root / "piecewise_icp_torch" / "csrc")
    # the program's state goes before the reference runs on the card
    entry_kind = cell.traffic["entry"]
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = judge.JUDGES[entry_kind](answers, epochs, gt, cell, seed, dev)
    checks["reference_s"] = time.perf_counter() - t_judge
    ctx.extra["plan_probes"] = checks.pop("plan_probes", None)
    ctx.extra["epoch_sizes"] = [len(e) for e in epochs]
    ctx.extra["campaign_outputs"] = [a["out"] for a in answers if "out" in a]
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for r in requests if not r["ok"])
    compared = {}
    correct = failed == 0 and bool(answers)
    for name, limit in cell.limits["limits"].items():
        value = checks[name]
        compared[name] = {"value": value, "limit": limit}
        if not (value <= limit):
            correct = False
    if not checks.get("answers_checked"):
        correct = False

    found = forbidden_modules()
    if found:
        say("modules of JAX or of the JAX package are loaded: "
            + ", ".join(found))
        return 3

    line = {"correct": correct, "attempted": len(requests),
            "failed": failed, "metrics": metrics,
            "device": device_info(dev, cell.chips, peak)}
    if traced:
        lo, hi = ctx.window_ns
        line["device"]["busy_s"] = stats.covered(
            trace.busy_intervals(ctx.ops)) * 1e-9
        line["device"]["window_s"] = (hi - lo) * 1e-9
        line["breakdown"] = trace.breakdown(ctx.ops, ctx.spans, lo, hi)
    line["checks"] = dict(compared, failed={"value": failed, "limit": 0})
    say("judged: " + json.dumps({k: v for k, v in checks.items()
                                 if k not in compared}))
    say(f"bytes written under the run's temporary folder: "
        f"{written_bytes(work)}")
    for name, c in compared.items():
        say(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    say(f"check failed = {failed} (limit 0); correct = {correct}")
    print(json.dumps(line), flush=True)
    return 0


def device_info(dev, chips: int, peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}
