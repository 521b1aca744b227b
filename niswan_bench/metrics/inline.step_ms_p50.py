"""The median latency of one in-line call over the measured window: from
the call with a host frame to the prediction in host memory."""

from niswan_bench.lib import readers


def read(ctx):
    return readers.percentile_ms(ctx, 50)
