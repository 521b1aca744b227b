"""The host time of a training step's upload (the port's span
``niswan.train.upload``: the step's ``prepare``, for the resident slab
``DeviceWindowSource.prepare``, the window starts' copy to the card), mean
over the profiled sub-window's steps."""

from niswan_bench.lib import program


def read(ctx):
    s = program.mean_host_s(ctx, "niswan.train.upload")
    return None if s is None else 1e3 * s
