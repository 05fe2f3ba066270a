"""One run of one cell: find the cell's configuration, traffic mix,
metrics and limits by name, make the inputs from the seed, set up and warm
the program on the cell's own shapes, measure a closed loop for the
window, judge what it produced against the plain reference, and print the
result's last line.

Everything that belongs to one configuration, mix, request kind, metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (named by the manifest), ``traffic/<mix>.json``,
``entries/<entry>.py`` (the mix's request kind, with its judge),
``metrics/<metric>.py`` (a ``read(ctx)`` returning a number or None) and
``limits/<cell>.json``.

A cell runs on its ``chips`` cards.  Command lines of the program that an
entry runs in processes of its own (:mod:`benchmark.child`) are measured
on their cards as this process is on its own, and merged into one reading
after the window: their spans and device operations, their memory peaks,
and a failure of any of them.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import logging
import pathlib
import re
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import child, stats, trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "piecewise_icp_tpu")
# a request kind's name: a module of benchmark/entries/
KIND_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


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

    def kind(self):
        """The module of the mix's request kind,
        ``benchmark.entries.<entry>``; LookupError where there is none."""
        name = self.traffic["entry"]
        module = f"benchmark.entries.{name}"
        if KIND_NAME.match(name):
            try:
                return importlib.import_module(module)
            except ModuleNotFoundError as e:
                if e.name != module:
                    raise
        raise LookupError(f"{self.name}: no request kind {name!r} "
                          f"(benchmark/entries/{name}.py)")

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
    """What a metric reader reads: the window's requests, the children's
    reports and, in the traced run, the spans, device operations and
    program kernels of this process and its children.  ``spans`` and
    ``ops`` hold (name, start ns, end ns) cut to the window; beside them
    ``span_procs`` names each span's process (``harness`` or a child's
    label), ``op_where`` each operation's (card, process), and ``procs``
    each process's card.  ``peaks`` holds each card's memory peak, summed
    over the processes on it (:func:`card_peaks`)."""

    def __init__(self, cell: Cell, setup_s: float, t_open: float,
                 requests: List[Dict]):
        self.cell = cell
        self.setup_s = setup_s
        self.t_open = t_open
        self.requests = requests
        self.traced = False
        self.spans: list = []
        self.span_procs: List[str] = []
        self.ops: list = []
        self.op_where: List[tuple] = []
        self.procs: Dict[str, str] = {}
        self.children: List[Dict] = []
        self.peaks: Dict[str, int] = {}
        self.window_ns = (0, 0)
        self.kernels: set = set()
        self.extra: Dict = {}

    def add_process(self, proc: str, card: str, spans, ops, cards) -> None:
        """A process's spans (name, start ns, end ns) that closed in the
        window, and its device operations, each on its card of ``cards``,
        cut to the window."""
        lo, hi = self.window_ns
        self.procs[proc] = card
        self.spans += spans
        self.span_procs += [proc] * len(spans)
        for (n, s, e), c in zip(ops, cards):
            if min(e, hi) > max(s, lo):
                self.ops.append((n, max(s, lo), min(e, hi)))
                self.op_where.append((c, proc))

    def card_ops(self, card: str) -> list:
        return [op for op, (c, _) in zip(self.ops, self.op_where)
                if c == card]

    def card_spans(self, card: str) -> list:
        return [s for s, p in zip(self.spans, self.span_procs)
                if self.procs[p] == card]

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
    try:
        kind = cell.kind()
    except LookupError as e:
        say(f"{e}: nothing measured")
        return 2
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
    if dev.type == "cuda":
        first = dev.index or 0
        devices = [torch.device("cuda", first + i)
                   for i in range(cell.chips)]
    else:
        devices = [dev] * cell.chips
    quiet_logs()

    work = pathlib.Path(tempfile.mkdtemp(prefix="pwicp_bench_"))
    children = child.Children(work / "children", traced)
    try:
        return _run(cell, kind, seed, seconds, traced, t_start, devices,
                    work, children, fault)
    finally:
        children.close()
        shutil.rmtree(work, ignore_errors=True)


def written_bytes(folder: pathlib.Path) -> int:
    """Bytes of the regular files under ``folder`` (links not followed)."""
    return sum(p.lstat().st_size for p in folder.rglob("*")
               if p.is_file() and not p.is_symlink())


def card_peaks(own: Dict[str, int], reports: List[Dict]) -> Dict[str, int]:
    """A card each, the sum of the memory peaks of the processes on it:
    this one's (``own``, by card) and its children's.  An upper bound of
    the card's own peak, since its processes need not peak at once."""
    peaks = dict(own)
    for r in reports:
        peaks[r["card"]] = peaks.get(r["card"], 0) + r["memory_peak_bytes"]
    return peaks


def close_entry(entry, children) -> list:
    """After the window: the entry's ``close()``, where it has one, then
    every child still open; the failures of children that exited
    non-zero."""
    late = []
    close = getattr(entry, "close", None)
    if close is not None:
        try:
            close()
        except child.ChildFailed as e:
            late.append(e)
    return late + children.close()


def _run(cell: Cell, kind, seed: int, seconds: float, traced: bool,
         t_start: float, devices: list, work: pathlib.Path, children,
         fault) -> int:
    import torch

    dev = devices[0]
    epochs, gt = make_inputs(cell.config, seed)
    if dev.type == "cuda":
        from piecewise_icp_torch.ops import _cuda

        _cuda.lib()                 # build (first run of a checkout), load
    entry = kind.ENTRY(epochs, gt, cell.config, cell.traffic, work, dev,
                       seconds, devices=devices, children=children)
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
    late = close_entry(entry, children)
    for e in late:                  # a child that exits non-zero fails
        say(str(e))
    if late:
        requests[-1]["ok"] = False
    reports = children.reports()
    own = {str(d): torch.cuda.max_memory_allocated(d)
           if d.type == "cuda" else 0 for d in devices}

    ctx = Context(cell, setup_s, t_open, requests)
    ctx.children = reports
    ctx.peaks = card_peaks(own, reports)
    if traced:
        ctx.traced = True
        ctx.window_ns = (t_open_ns, t_close_ns)
        ctx.add_process("harness", str(dev),
                        trace.span_intervals(records, t_open_ns, t_close_ns),
                        prof_out["ops"], prof_out["cards"])
        for r in reports:
            names = r["op_names"]
            ctx.add_process(
                r["label"], r["card"],
                trace.span_intervals(r["records"], t_open_ns, t_close_ns),
                [(names[i], s, e) for i, s, e, _ in r["ops"]],
                [c for *_, c in r["ops"]])
        ctx.kernels = trace.program_kernels(
            cell.root / "piecewise_icp_torch" / "csrc")
    # the program's state goes before the reference runs on the card
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = kind.JUDGE(answers, epochs, gt, cell, seed, dev)
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

    found = forbidden_modules() + [
        f"{m} (in {r['label']})" for r in reports
        for m in r.get("forbidden", [])]
    if found:
        say("modules of JAX or of the JAX package are loaded: "
            + ", ".join(found))
        return 3

    line = {"correct": correct, "attempted": len(requests),
            "failed": failed, "metrics": metrics,
            "device": device_info(dev, cell.chips,
                                  max(ctx.peaks.values()))}
    if traced:
        # each card's busy union, summed over the cell's cards, against
        # the window on each: their ratio is the cards' mean busy share
        lo, hi = ctx.window_ns
        cards = list(dict.fromkeys(str(d) for d in devices))
        line["device"]["busy_s"] = sum(
            stats.covered(trace.busy_intervals(ctx.card_ops(c)))
            for c in cards) * 1e-9
        line["device"]["window_s"] = (hi - lo) * 1e-9 * cell.chips
        line["breakdown"] = trace.breakdown(
            [(ctx.card_ops(c), ctx.card_spans(c)) for c in cards], lo, hi)
        outside = sum(1 for c, _ in ctx.op_where if c not in cards)
        if outside:
            say(f"{outside} device operations ran outside the cell's "
                f"cards {cards}")
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
