"""The JAX package's native netCDF reader, loaded once per test process
whatever other processes do at the same time.

``nasa_niswan_tpu.data.ncio_native`` builds ``native/libnc3read.so`` at
its first use through one shared ``.tmp`` path, and latches its first
answer (``_tried``).  Under pytest-xdist several workers may build at once:
the one whose ``os.replace`` finds the ``.tmp`` gone gets no library and
never tries again in that process, so every CDF-5 read of the JAX package
fails there (scipy reads no CDF-5).  ``load()`` takes an ``fcntl`` lock on a
file under ``build/`` while it asks, so the port's tests build one at a
time, and when the answer was no while the library now exists (another
process's build won), clears the latch and loads that library.  Without a
working ``g++`` the answer stays no and the CDF-5 comparisons fail as
before: nothing is skipped.
"""

import fcntl
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load() -> bool:
    from nasa_niswan_tpu.data import ncio_native

    lock_dir = os.path.join(ROOT, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "jax_nc3read.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ok = ncio_native.available()
        if not ok and os.path.exists(os.path.join(ROOT, "native", "libnc3read.so")):
            ncio_native._tried = False
            ok = ncio_native.available()
    return ok
