"""The share of the profiled sub-window in which the card is inside one of
the in-line calls' graph replays, one a call (the port's span
``niswan.graph.replay``, timed by its CUDA events: from the moment the
stream reaches the replay to its last operation)."""

from niswan_bench.lib import program


def read(ctx):
    return program.device_share_percent(ctx, "niswan.graph.replay")
