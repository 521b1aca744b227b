"""The cell kernels of a remat training step together (B1, B2 (a), dW and
B3: kernel classes ``b1``, ``b2a``, ``dw``, ``b3``): the least time of the
traced sub-window's launches, worked out from their shapes, over their
device time."""

from niswan_bench.lib import readers, work

CLASSES = ("b1", "b2a", "dw", "b3")


def read(ctx):
    tw = ctx.trace_window
    if tw is None or "steps" not in tw:
        return None
    bound = tw["steps"] * work.train_cell_kernels_bound_s(ctx.config, tw["batch"], tw["seq"])
    return readers.roofline_percent(ctx, CLASSES, bound)
