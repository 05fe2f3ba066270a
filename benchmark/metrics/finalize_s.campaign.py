"""finalize_s.campaign: chaining to the reference epoch and Kalman
smoothing (``chaining`` + ``kalman`` in each campaign's
``phase_timings.jsonl``; the program times no table writing), s a
campaign."""

from benchmark.metrics_io import phase_seconds


def read(ctx):
    return phase_seconds(ctx, ("chaining", "kalman"))
