"""The host time of an in-line call's frame upload (the port's span
``niswan.serve.upload``: the pinned frame to the card, and the stream's
wait that ends the copy), mean over the profiled sub-window's calls."""

from niswan_bench.lib import program


def read(ctx):
    s = program.mean_host_s(ctx, "niswan.serve.upload")
    return None if s is None else 1e6 * s
