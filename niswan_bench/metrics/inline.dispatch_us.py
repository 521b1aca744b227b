"""The host time of an in-line call's graph runner (the port's span
``niswan.graph.run``: the key and lookup, the staging copies, the replay's
launch, the launch counters and the output's copy), mean over the profiled
sub-window's calls."""

from niswan_bench.lib import program


def read(ctx):
    s = program.mean_host_s(ctx, "niswan.graph.run")
    return None if s is None else 1e6 * s
