"""The host seconds the port spent making its CUDA kernels ready since the
process started (its counter ``kernels.load_s``: the sources' digest, nvcc
where the library is not built, the load)."""

from niswan_bench.lib import program


def read(ctx):
    return program.counter("kernels.load_s")
