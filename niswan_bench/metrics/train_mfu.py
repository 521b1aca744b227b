"""Model FLOP utilization of training: three times the forward's FLOPs of
every step in the measured window (the remat route's recompute not
counted) over its wall time at the card's dense bf16 peak."""

from niswan_bench.lib import readers, work


def read(ctx):
    w = ctx.window
    if "steps" not in w:
        return None
    return readers.mfu_percent(
        ctx, w["steps"] * work.train_step_flops(ctx.config, w["batch"], w["seq"]))
