"""Structured logging + per-phase timing records.

The reference narrates progress with unstructured ``std::cout`` and times
phases with ``pcl::console::TicToc`` (Segmentation.cpp:26-47,
Registration.cpp:91-184) without recording anything.  Here phase timings are
collected into a structured record that callers can dump as JSON metrics,
and logging goes through the standard library logger
``piecewise_icp_torch``.  The port's own copy of
``piecewise_icp_tpu/utils/logging.py``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Dict, List

log = logging.getLogger("piecewise_icp_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[pwicp] %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class PhaseTimer:
    """Collects wall-clock timings per named phase."""

    def __init__(self) -> None:
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = {"phase": name, "seconds": dt, **meta}
            self.records.append(rec)
            log.debug("phase %s: %.3fs", name, dt)

    def total(self) -> float:
        return sum(r["seconds"] for r in self.records)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out


# Module-level timer for fine-grained pipeline phase attribution.  Pipeline
# stages record into it unconditionally (contextmanager overhead ~us); entry
# points may reset/read it for reporting.
GLOBAL_TIMER = PhaseTimer()


def gphase(name: str, **meta):
    """Record a phase into the global timer."""
    return GLOBAL_TIMER.phase(name, **meta)
