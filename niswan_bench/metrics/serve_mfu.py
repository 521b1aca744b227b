"""Model FLOP utilization of chained serving: the emulator's FLOPs over the
measured window (every cell's gate conv and the head, per step, on the
padded grid) over its wall time at the card's dense bf16 peak."""

from niswan_bench.lib import readers, work


def read(ctx):
    w = ctx.window
    if "frames" not in w:
        return None
    return readers.mfu_percent(ctx, w["frames"] * work.serve_step_flops(ctx.config, w["batch"]))
