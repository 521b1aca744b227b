"""Builds the JAX package's native netCDF reader once, before any test
process imports a test file.

``nasa_niswan_tpu.data.ncio_native`` builds ``native/libnc3read.so`` at
its first use through one shared ``.tmp`` path, and
``tests/test_ncio_native.py`` decides its skip when it is imported.  Under
pytest-xdist every worker imports it at once on a fresh checkout: a
worker whose build loses the race gets no library and skips the file.
``pytest_configure`` here runs on the controller (a worker has
``config.workerinput``) before any worker starts, so the library exists
and is current when the workers ask.  It loads the module from its file,
not through its package, which would import JAX into a process that may
run the benchmark's tests (they refuse a process holding JAX).  Without a
working ``g++`` nothing changes: the reader stays unavailable and those
tests skip as before.
"""

import importlib.util
import os


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nasa_niswan_tpu", "data", "ncio_native.py")
    spec = importlib.util.spec_from_file_location("_ncio_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.available()
