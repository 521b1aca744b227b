#!/usr/bin/env python3
"""Host-side day-file read microbench of the port: the native C++ reader
against scipy, the twin of scripts/bench_ncread.py.

    python scripts/torch_bench_ncread.py [--out OUT]

The lazy real-data loaders (``data/netcdf.py``) open five daily files per
day not in their cache; this measures that floor at a realistic day-file
size (``data/ncfixture.write_fixture_tree``: one day of 48 half-hourly
steps on the 90 x 144 grid, 20-level 4-D families), every array of every
file touched, through ``data/ncio_native.open_nc_native`` and
``ncio._open_scipy``, whose arrays must be equal (``native_equals_scipy``).
Then one surface-species day through the targeted reads of
``read_day_fields``, with and without ``NISWAN_NO_NATIVE_NC=1``, and the
on-disk format matrix: a two-day surface tree in netCDF3, CDF-5 and
netCDF4, read through ``ncio.open_nc`` (the loaders' dispatch), and the
lazy single-step dataset's samples per second on each.  netCDF4 needs
h5py: where it is not installed that row is not run and says so
(``netcdf4_not_run``).  Runs on the host; no device is used, and
``card`` names the machine's card (nvidia-smi's name and power limit)
where it has one.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import torch_trace_summary as ts  # noqa: E402
from nasa_niswan_tpu_torch.data import ncio  # noqa: E402
from nasa_niswan_tpu_torch.data.ncfixture import write_fixture_tree  # noqa: E402
from nasa_niswan_tpu_torch.data.ncio_native import available, open_nc_native  # noqa: E402
from nasa_niswan_tpu_torch.data.netcdf import (  # noqa: E402
    LazyE33OMASingleStep,
    load_time_index,
    read_day_fields,
)

STEPS_PER_DAY = 48
GRID = (90, 144)
LEVELS = 20
REPS = 5
SAMPLES = 64  # lazy-dataset samples per pass
FORMATS = ("netcdf3", "cdf5", "netcdf4")


def timeit(fn, reps=REPS):
    fn()  # warm page cache
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - tic) / reps


def read_all(opener, paths):
    for p in paths:
        f = opener(p)
        for n in f.variables:
            np.asarray(f[n]).sum()  # touch every array


def same_arrays(paths) -> bool:
    """Whether the native reader gives scipy's variables, bit for bit."""
    for p in paths:
        a, b = open_nc_native(p), ncio._open_scipy(p)
        if a is None or sorted(a.variables) != sorted(b.variables):
            return False
        for n in b.variables:
            x, y = a[n], b[n]
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
    return True


def day_files(d: str, days: int, fmt: str = "netcdf3"):
    write_fixture_tree(d, days=days, steps_per_day=STEPS_PER_DAY, H=GRID[0], W=GRID[1],
                       levels=LEVELS, fmt=fmt)
    return sorted(glob.glob(os.path.join(d, "*.nc")))


def day_fields_ms(d: str, date: str) -> tuple:
    """ms of one surface-species day through read_day_fields, native and
    with NISWAN_NO_NATIVE_NC=1 (the variable restored afterwards)."""
    t_native = timeit(lambda: read_day_fields(d, date, "bcb"))
    before = os.environ.get("NISWAN_NO_NATIVE_NC")
    os.environ["NISWAN_NO_NATIVE_NC"] = "1"
    try:
        t_scipy = timeit(lambda: read_day_fields(d, date, "bcb"))
    finally:
        if before is None:
            del os.environ["NISWAN_NO_NATIVE_NC"]
        else:
            os.environ["NISWAN_NO_NATIVE_NC"] = before
    return t_native, t_scipy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args(argv)
    if not available():
        raise SystemExit("native reader not built (data/ncio_native.available() is False)")
    with tempfile.TemporaryDirectory() as d:
        paths = day_files(d, days=1)
        total_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        equal = same_arrays(paths)
        t_scipy = timeit(lambda: read_all(ncio._open_scipy, paths))
        t_native = timeit(lambda: read_all(open_nc_native, paths))
        date = load_time_index(d)[0].strftime("%Y%m%d")
        t_day, t_day_scipy = day_fields_ms(d, date)
        out = {
            "day_files": len(paths),
            "total_MB": total_mb,
            "native_equals_scipy": equal,
            "scipy_ms": t_scipy * 1e3,
            "native_ms": t_native * 1e3,
            "speedup": t_scipy / t_native,
            "native_GBps": total_mb / 1e3 / t_native,
            "day_fields_scipy_ms": t_day_scipy * 1e3,
            "day_fields_native_ms": t_day * 1e3,
            "day_fields_speedup": t_day_scipy / t_day,
        }

    # the on-disk format matrix through open_nc's dispatch, and the
    # training-feed unit (lazy dataset samples/sec)
    for fmt in FORMATS:
        if fmt == "netcdf4" and importlib.util.find_spec("h5py") is None:
            out[f"{fmt}_open_ms"] = out[f"{fmt}_lazy_samples_per_s"] = None
            out[f"{fmt}_not_run"] = "h5py is not installed"
            continue
        with tempfile.TemporaryDirectory() as d:
            paths = day_files(d, days=2, fmt=fmt)
            out[f"{fmt}_open_ms"] = timeit(lambda: read_all(ncio.open_nc, paths)) * 1e3
            ds = LazyE33OMASingleStep(d, period="train", species="bcb", padding=None)
            n = min(len(ds), SAMPLES)

            def sample_pass():
                for i in range(n):
                    ds[i]

            out[f"{fmt}_lazy_samples_per_s"] = n / timeit(sample_pass, reps=3)
    out["host_cpus"] = os.cpu_count()
    out["card"] = ts.card("cuda") if shutil.which("nvidia-smi") else None
    print(json.dumps(out), flush=True)
    ts.write_json(out, args.out)
    return out


if __name__ == "__main__":
    main()
