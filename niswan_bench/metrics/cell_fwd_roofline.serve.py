"""B1 (the fused cell forward, kernel class ``b1``) in serving: the least
time of the traced sub-window's B1 launches, worked out from their shapes,
over their device time."""

from niswan_bench.lib import readers, work


def read(ctx):
    tw = ctx.trace_window
    if tw is None or "frames" not in tw:
        return None
    bound = tw["frames"] * work.serve_b1_bound_s(ctx.config, tw["batch"])
    return readers.roofline_percent(ctx, ("b1",), bound)
