"""What the traced run reads: the program's host spans, stamped with
their end on the realtime clock, and the device's activity from
``torch.profiler``.

The program's ``GLOBAL_TIMER`` records each span's name and length when
the span closes.  :func:`stamp_spans` swaps its record list for one that
also notes the close, in the nanoseconds of ``time.time_ns()``, the clock
of the profiler's timestamps, so a span's interval is [close - length,
close].  Nothing else of the program changes.
"""

from __future__ import annotations

import contextlib
import pathlib
import re
import time
from typing import Dict, List, Tuple

from . import stats

Interval = Tuple[float, float]
# a device operation's name in the breakdown: templated library kernels
# run to thousands of characters; their head tells them apart
NAME_CHARS = 160


class StampedRecords(list):
    """A span record list that stamps each record as it is appended."""

    def append(self, rec) -> None:
        rec["end_ns"] = time.time_ns()
        super().append(rec)


def stamp_spans(timer) -> StampedRecords:
    """Make ``timer`` (a ``PhaseTimer``) stamp every record from now on."""
    timer.records = StampedRecords(timer.records)
    return timer.records


def span_intervals(records, lo_ns: int, hi_ns: int
                   ) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the stamped spans that closed in
    [lo_ns, hi_ns]."""
    out = []
    for r in records:
        end = r.get("end_ns")
        if end is not None and lo_ns <= end <= hi_ns:
            out.append((r["phase"], end - int(r["seconds"] * 1e9), end))
    return out


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def program_kernels(csrc: pathlib.Path) -> set:
    """The names of the program's own kernels: every ``__global__``
    function of its CUDA sources."""
    names = set()
    for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(p.read_text()))
    return names


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::foo<3>(Grid, int)`` -> ``foo``."""
    head = kernel.split("(", 1)[0] if not kernel.startswith("void (") \
        else kernel[5:]
    if head.startswith("(anonymous namespace)::"):
        head = head[len("(anonymous namespace)::"):]
    head = head.split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].rsplit(" ", 1)[-1]


@contextlib.contextmanager
def device_profile(on_cuda: bool = True):
    """Profile the device's activity of the block (kernels, copies,
    fills); yields a dict that receives ``ops``: [(name, start ns, end
    ns)] once the block has ended, and ``cards``: the card of each
    (``cuda:<index>``).  ``on_cuda`` False (the CPU tests) traces host
    operations only, so both stay empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, list] = {}
    act = ProfilerActivity.CUDA if on_cuda else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        yield out
    ops, cards = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.duration_ns()
        if dur > 0:
            ops.append((e.name(), e.start_ns(), e.start_ns() + dur))
            cards.append(f"cuda:{e.device_index()}")
    out["ops"] = ops
    out["cards"] = cards


def busy_intervals(ops) -> List[Interval]:
    return [(s, e) for _, s, e in ops]


def span_at(spans, times) -> List[str]:
    """For each of the sorted ``times``, the name of the latest-started
    span open there (the innermost, where spans nest), or ``unspanned``."""
    events = []
    for k, (_, s, e) in enumerate(spans):
        events.append((s, 0, k))
        events.append((e, 2, k))
    for k, t in enumerate(times):
        events.append((t, 1, k))
    events.sort()
    out = ["unspanned"] * len(times)
    active: List[int] = []
    for _, kind, k in events:
        if kind == 0:
            active.append(k)
        elif kind == 2:
            active.remove(k)
        elif active:
            out[k] = spans[active[-1]][0]
    return out


def breakdown(cards, lo_ns: int, hi_ns: int, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the devices summed by the host span open at each gap's middle;
    seconds, at most ``top`` of each.  ``cards`` holds, a card each, its
    device operations and the host spans of the processes on it: the
    operations are summed by name over the cards, and each card's idle
    time is billed to the spans of its own processes."""
    by_op: Dict[str, float] = {}
    by_gap: Dict[str, float] = {}
    for ops, spans in cards:
        for name, s, e in ops:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-9
        idle = stats.gaps(busy_intervals(ops), lo_ns, hi_ns)
        names = span_at(spans, [0.5 * (s + e) for s, e in idle])
        for name, (s, e) in zip(names, idle):
            by_gap[name] = by_gap.get(name, 0.0) + (e - s) * 1e-9

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}
