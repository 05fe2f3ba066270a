"""Helpers the campaign metrics share: the phases of each campaign's
``phase_timings.jsonl``."""

from __future__ import annotations

import json
import pathlib
from typing import Optional, Sequence


def phase_seconds(ctx, phases: Sequence[str]) -> Optional[float]:
    """Seconds of ``phases`` summed, a campaign of the window, from the
    ``phase_timings.jsonl`` each campaign wrote; None where none did."""
    outs = ctx.extra.get("campaign_outputs", [])
    total, n = 0.0, 0
    for out in outs:
        path = pathlib.Path(out) / "phase_timings.jsonl"
        if not path.exists():
            continue
        n += 1
        for ln in path.read_text().splitlines():
            rec = json.loads(ln)
            if rec.get("phase") in phases:
                total += float(rec["seconds"])
    return total / n if n else None
