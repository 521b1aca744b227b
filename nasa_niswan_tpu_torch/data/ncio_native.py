"""ctypes binding for the native netCDF3 reader (counterpart of
nasa_niswan_tpu/data/ncio_native.py).

The reader, ``native/nc3read.cpp`` in the repository, mmaps a netCDF3
classic / CDF-2 / CDF-5 file, parses its header in C++ and byte-swaps each
variable straight into numpy buffers.  This module compiles that source as
it is, with g++, into ``build/nc3read/libnc3read_<hash>.so`` (the hash
covers the source and the flags) at first use.  The compiler writes a name
of its own process and thread, which ``os.replace`` then moves into place,
so concurrent builds (test workers) never read a half-written library, and
nothing is written under ``native/``.  Where g++ or the build is missing,
``available()`` is False and data/ncio falls back to scipy.

``reads`` counts the files and variable sets the native reader parsed, so
a run can show that it did not fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native" / "nc3read.cpp"
BUILD_DIR = ROOT / "build" / "nc3read"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_NC_DTYPES = {
    1: np.dtype(np.int8),
    2: np.dtype("S1"),
    3: np.dtype(np.int16),
    4: np.dtype(np.int32),
    5: np.dtype(np.float32),
    6: np.dtype(np.float64),
    # CDF-5 (64-bit data) additions
    7: np.dtype(np.uint8),
    8: np.dtype(np.uint16),
    9: np.dtype(np.uint32),
    10: np.dtype(np.int64),
    11: np.dtype(np.uint64),
}

reads = 0  # successful native parses (open_nc_native, read_vars, read_var_slice)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libnc3read_{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile native/nc3read.cpp unless its library exists; the path, or
    None when the source or the compiler is missing or the build fails."""
    if not NATIVE_SRC.is_file():
        return None
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(NATIVE_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def _build_and_load() -> Optional[ctypes.CDLL]:
    so = build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.nc3_open.restype = ctypes.c_void_p
    lib.nc3_open.argtypes = [ctypes.c_char_p]
    lib.nc3_close.argtypes = [ctypes.c_void_p]
    lib.nc3_num_vars.restype = ctypes.c_int
    lib.nc3_num_vars.argtypes = [ctypes.c_void_p]
    lib.nc3_var_name.restype = ctypes.c_char_p
    lib.nc3_var_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nc3_var_info.restype = ctypes.c_int
    lib.nc3_var_info.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
    ]
    lib.nc3_var_dim_name.restype = ctypes.c_char_p
    lib.nc3_var_dim_name.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.nc3_var_attr_text.restype = ctypes.c_long
    lib.nc3_var_attr_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.nc3_read.restype = ctypes.c_int
    lib.nc3_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    lib.nc3_read_levels.restype = ctypes.c_int
    lib.nc3_read_levels.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build_and_load()
    return _lib


def available() -> bool:
    return _get_lib() is not None


def _count_read() -> None:
    global reads
    with _lock:
        reads += 1


def _var_info(lib, h, name: str, file_size: int, *, min_ndim: int = 0):
    """(shape, dtype) of a variable, or None for a corrupt header (a shape
    larger than the file is refused before numpy tries to allocate it)."""
    shape = (ctypes.c_uint64 * 8)()
    ndim, typ = ctypes.c_int(), ctypes.c_int()
    if lib.nc3_var_info(h, name.encode(), ctypes.byref(ndim), shape, ctypes.byref(typ)):
        return None
    if not min_ndim <= ndim.value <= 8 or typ.value not in _NC_DTYPES:
        return None
    shp = tuple(int(shape[k]) for k in range(ndim.value))
    dt = _NC_DTYPES[typ.value]
    nbytes = dt.itemsize
    for s in shp:
        nbytes *= s
    if nbytes > file_size:
        return None
    return shp, dt


def _time_axis(lib, h, values):
    """The decoded time axis from the values and the attributes of "time";
    None when its units or values are corrupt."""
    from nasa_niswan_tpu_torch.data.ncio import decode_noleap_times

    buf = ctypes.create_string_buffer(256)

    def attr(a, default):
        n = lib.nc3_var_attr_text(h, b"time", a, buf, 256)
        return buf.raw[:n].decode() if n >= 0 else default

    try:
        return decode_noleap_times(
            values,
            attr(b"units", "days since 1950-01-01"),
            attr(b"calendar", "noleap"),
        )
    except (ValueError, OverflowError):  # corrupt units or values: keep the data, drop time
        return None


def open_nc_native(path: str):
    """Parse a netCDF3 classic file with the native reader; the same
    ``NcFile`` contract as ncio._open_scipy (every variable materialized
    little-endian, the decoded no-leap time axis) or None when the native
    path is unavailable or the file is not parseable."""
    lib = _get_lib()
    if lib is None:
        return None
    from nasa_niswan_tpu_torch.data.ncio import NcFile

    h = lib.nc3_open(path.encode())
    if not h:
        return None
    try:
        variables, dims = {}, {}
        file_size = os.path.getsize(path)
        for i in range(lib.nc3_num_vars(h)):
            raw_name = lib.nc3_var_name(h, i)
            if raw_name is None:
                return None
            name = raw_name.decode(errors="replace")
            info = _var_info(lib, h, name, file_size)
            if info is None:
                return None
            shp, dt = info
            arr = np.empty(shp, dt)
            lead = shp[0] if shp else 1
            if lib.nc3_read(h, name.encode(), 0, lead,
                            arr.ctypes.data_as(ctypes.c_void_p)):
                return None
            variables[name] = arr
            dim_names = [
                lib.nc3_var_dim_name(h, name.encode(), k) for k in range(len(shp))
            ]
            if any(d is None for d in dim_names):
                return None
            dims[name] = tuple(d.decode(errors="replace") for d in dim_names)
        time = None
        if "time" in variables:
            time = _time_axis(lib, h, variables["time"])
        _count_read()
        return NcFile(variables, dims, time)
    finally:
        lib.nc3_close(h)


def read_vars(path: str, names, *, levels: Optional[int] = None) -> Optional[dict]:
    """Open once and read only the named variables (plus the decoded time
    axis under key "time" when present).

    ``levels=k`` keeps only the first k entries of any variable whose
    second dimension is named "level" (the (time, level, lat, lon)
    families), copying just those bytes."""
    lib = _get_lib()
    if lib is None:
        return None
    h = lib.nc3_open(path.encode())
    if not h:
        return None
    try:
        out = {}
        file_size = os.path.getsize(path)

        def read_full(name):
            info = _var_info(lib, h, name, file_size)
            if info is None:
                return None
            shp, dt = info
            if (
                levels is not None and len(shp) >= 2
                and (lib.nc3_var_dim_name(h, name.encode(), 1) or b"").decode()
                == "level"
            ):
                k = min(levels, shp[1])
                arr = np.empty((shp[0], k) + shp[2:], dt)
                if lib.nc3_read_levels(
                    h, name.encode(), 0, shp[0], 0, k,
                    arr.ctypes.data_as(ctypes.c_void_p),
                ):
                    return None
                return arr
            arr = np.empty(shp, dt)
            if lib.nc3_read(h, name.encode(), 0, shp[0] if shp else 1,
                            arr.ctypes.data_as(ctypes.c_void_p)):
                return None
            return arr

        for n in names:
            arr = read_full(n)
            if arr is None:
                return None
            out[n] = arr
        tvals = read_full("time")
        if tvals is not None:
            out["time"] = _time_axis(lib, h, tvals)
        _count_read()
        return out
    finally:
        lib.nc3_close(h)


def read_var_slice(
    path: str, name: str, start: int, count: int
) -> Optional[np.ndarray]:
    """Read only records [start, start+count) of one variable."""
    lib = _get_lib()
    if lib is None:
        return None
    h = lib.nc3_open(path.encode())
    if not h:
        return None
    try:
        info = _var_info(lib, h, name, os.path.getsize(path), min_ndim=1)
        if info is None:
            return None
        shp, dt = info
        if count * int(np.prod(shp[1:], dtype=np.int64)) * dt.itemsize > os.path.getsize(path):
            return None
        arr = np.empty((count,) + shp[1:], dt)
        if lib.nc3_read(h, name.encode(), start, count,
                        arr.ctypes.data_as(ctypes.c_void_p)):
            return None
        _count_read()
        return arr
    finally:
        lib.nc3_close(h)
