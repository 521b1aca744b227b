"""The host seconds the port spent capturing CUDA graphs since the process
started (its counter ``graph.capture_s``: a serving runner's warm-up and
capture, a training step's eager first call and capture)."""

from niswan_bench.lib import program


def read(ctx):
    return program.counter("graph.capture_s")
