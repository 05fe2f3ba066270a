"""plan_s.campaign: the adaptive planning phase (``pair_planning`` in each
campaign's ``phase_timings.jsonl``), s a campaign."""

from benchmark.metrics_io import phase_seconds


def read(ctx):
    return phase_seconds(ctx, ("pair_planning",))
