"""Minimal netCDF I/O with no-leap calendar decoding (counterpart of
nasa_niswan_tpu/data/ncio.py), written without pandas, xarray or a
module-level h5py import.

* ``open_nc(path)`` reads a netCDF file's variables and decoded time axis.
  It dispatches on the file's magic bytes: ``CDF`` (netCDF3 classic, CDF-2
  and CDF-5) goes to the native reader (data/ncio_native.py), then to
  ``scipy.io.netcdf_file`` for CDF-1/2; the HDF5 signature (netCDF4) goes
  to h5py, imported only there, so a machine without h5py reads every
  netCDF3 file and raises an ``ImportError`` naming h5py for netCDF4.
* ``write_nc(path, ..., fmt=...)`` writes netCDF3 (scipy), CDF-5 (the
  64-bit-data classic format, record layout) or netCDF4 (h5py dimension
  scales, where h5py is installed).
* ``decode_noleap_times(values, units, calendar)`` decodes "<unit> since
  <base>" under the 365-day no-leap calendar, each calendar date mapped
  onto the same proleptic-Gregorian date (cftime's ``to_datetimeindex``).
  It returns a ``TimeIndex``: nanosecond instants in a numpy
  ``datetime64[ns]`` array, equal to the instants of the JAX package's
  pandas ``DatetimeIndex``, with the part of its interface the loaders use.
"""

from __future__ import annotations

import datetime as _dt
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

_UNIT_SECONDS = {
    "second": 1.0,
    "seconds": 1.0,
    "sec": 1.0,
    "secs": 1.0,
    "minute": 60.0,
    "minutes": 60.0,
    "min": 60.0,
    "mins": 60.0,
    "hour": 3600.0,
    "hours": 3600.0,
    "hr": 3600.0,
    "hrs": 3600.0,
    "day": 86400.0,
    "days": 86400.0,
}

_NOLEAP_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_NOLEAP_CUM = np.concatenate([[0], np.cumsum(_NOLEAP_MONTH_DAYS)])  # per month
_EPOCH = _dt.datetime(1970, 1, 1)


class Stamp(_dt.datetime):
    """One instant of a ``TimeIndex``: a ``datetime.datetime`` (microsecond
    resolution, for ``strftime``, ``month`` and the other fields) that also
    carries its exact nanoseconds since 1970 in ``value``, as a pandas
    ``Timestamp`` does."""

    value: int

    @classmethod
    def from_ns(cls, ns: int) -> "Stamp":
        ns = int(ns)
        d = _EPOCH + _dt.timedelta(microseconds=ns // 1000)
        out = cls(d.year, d.month, d.day, d.hour, d.minute, d.second, d.microsecond)
        out.value = ns
        return out


class TimeIndex:
    """A sequence of instants on nanoseconds (``datetime64[ns]``): ``len``,
    iteration and integer indexing (a ``Stamp``), slicing and integer-array
    indexing (a ``TimeIndex``), ``append``, ``month``, ``strftime``,
    ``asi8`` and ``values`` as in pandas; ``index - stamp`` gives the int64
    nanosecond differences."""

    def __init__(self, values):
        self.values = np.asarray(values, dtype="datetime64[ns]").reshape(-1)

    @property
    def asi8(self) -> np.ndarray:
        return self.values.view(np.int64)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return Stamp.from_ns(self.asi8[key])
        return TimeIndex(self.values[key])

    def __iter__(self):
        return (Stamp.from_ns(v) for v in self.asi8)

    def __sub__(self, other) -> np.ndarray:
        return self.asi8 - int(other.value)

    def __eq__(self, other):
        other = other.values if isinstance(other, TimeIndex) else np.asarray(
            other, dtype="datetime64[ns]")
        return self.values == other

    __hash__ = None

    def append(self, others) -> "TimeIndex":
        if isinstance(others, TimeIndex):
            others = [others]
        return TimeIndex(np.concatenate([self.values] + [o.values for o in others]))

    @property
    def month(self) -> np.ndarray:
        months = self.values.astype("datetime64[M]").astype(np.int64)
        return (months % 12 + 1).astype(np.int32)

    def strftime(self, fmt: str):
        return [t.strftime(fmt) for t in self]

    def __repr__(self) -> str:
        return f"TimeIndex({self.values!r})"


def _parse_time_units(units: str) -> Tuple[float, Tuple[int, int, int, int, int, int]]:
    """'hours since 1950-1-1 00:00:00' -> (3600.0, (1950,1,1,0,0,0))."""
    m = re.match(
        r"\s*(\w+)\s+since\s+(\d{1,4})-(\d{1,2})-(\d{1,2})"
        r"(?:[ T](\d{1,2}):(\d{1,2})(?::(\d{1,2}(?:\.\d*)?))?)?",
        units,
    )
    if not m:
        raise ValueError(f"unparseable time units: {units!r}")
    unit = m.group(1).lower()
    if unit not in _UNIT_SECONDS:
        raise ValueError(f"unsupported time unit {unit!r} in {units!r}")
    base = (
        int(m.group(2)),
        int(m.group(3)),
        int(m.group(4)),
        int(m.group(5) or 0),
        int(m.group(6) or 0),
        int(float(m.group(7) or 0)),
    )
    return _UNIT_SECONDS[unit], base


def _seconds_ns(secs: np.ndarray) -> np.ndarray:
    """Float seconds -> int64 nanoseconds, truncated toward zero as a
    pandas ``Timedelta(seconds=s)`` is."""
    return (np.asarray(secs, np.float64) * 1e9).astype(np.int64)


def _date_ns(year, month, day) -> np.ndarray:
    """Proleptic-Gregorian midnights of (year, month, day) arrays, as
    int64 nanoseconds since 1970."""
    y = (np.asarray(year, np.int64) - 1970).astype("datetime64[Y]")
    m = y.astype("datetime64[M]") + (np.asarray(month, np.int64) - 1)
    d = m.astype("datetime64[D]") + (np.asarray(day, np.int64) - 1)
    return d.astype("datetime64[ns]").view(np.int64)


def decode_noleap_times(
    values: np.ndarray, units: str, calendar: str = "noleap"
) -> TimeIndex:
    """Decode "<unit> since <base>" time values to a ``TimeIndex``.

    For the no-leap (365_day) calendar each calendar date is mapped to the
    same proleptic-Gregorian date (cftime ``to_datetimeindex`` semantics);
    standard/gregorian calendars count seconds from the base.
    """
    scale, base = _parse_time_units(units)
    secs = np.atleast_1d(np.asarray(values, dtype=np.float64)) * scale
    cal = (calendar or "standard").lower()
    if cal in ("noleap", "365_day", "365day"):
        by, bm, bd, bh, bmin, bs = base
        base_day_of_year = _NOLEAP_CUM[bm - 1] + (bd - 1)
        base_secs = (
            base_day_of_year * 86400.0 + bh * 3600.0 + bmin * 60.0 + bs
        )
        tot = secs + base_secs  # seconds since year `by` day 0
        year = by + np.floor_divide(tot, 365.0 * 86400.0).astype(np.int64)
        rem = np.mod(tot, 365.0 * 86400.0)
        doy = np.floor_divide(rem, 86400.0).astype(np.int64)
        sod = rem - doy * 86400.0
        month = np.searchsorted(_NOLEAP_CUM, doy, side="right")  # 1..12
        dom = doy - _NOLEAP_CUM[month - 1] + 1
        # noleap dates never include Feb 29, so every (y, m, d) is a valid
        # Gregorian date
        ns = _date_ns(year, month, dom) + _seconds_ns(sod)
    else:
        by, bm, bd, bh, bmin, bs = base
        base_ns = int(_date_ns(by, bm, bd)) + (bh * 3600 + bmin * 60 + bs) * 10**9
        ns = base_ns + _seconds_ns(secs)
    return TimeIndex(ns.view("datetime64[ns]"))


class NcFile:
    """One opened netCDF file: numpy variables + a decoded time index.

    ``variables`` maps names to numpy arrays (copied out of any mmap, so
    the handle can be closed at once); ``dims`` maps names to their
    dimension tuples; ``time`` is the decoded ``TimeIndex`` (None when the
    file has no time coordinate).
    """

    def __init__(
        self,
        variables: Dict[str, np.ndarray],
        dims: Dict[str, Tuple[str, ...]],
        time: Optional[TimeIndex],
    ):
        self.variables = variables
        self.dims = dims
        self.time = time

    def __getitem__(self, name: str) -> np.ndarray:
        return self.variables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables

    @property
    def data_vars(self):
        """Variable names that are not coordinate/dimension variables."""
        return [
            n for n, d in self.dims.items()
            if n not in ("time", "lat", "lon", "level", "latitude", "longitude")
        ]

    def close(self):  # data already copied out; nothing to release
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _attr_str(var, name, default=""):
    v = getattr(var, name, default)
    if isinstance(v, bytes):
        v = v.decode()
    return v


def _open_scipy(path: str) -> NcFile:
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        variables: Dict[str, np.ndarray] = {}
        dims: Dict[str, Tuple[str, ...]] = {}
        for name, var in f.variables.items():
            arr = np.array(var.data)
            if arr.dtype.byteorder == ">":  # netCDF3 stores big-endian
                arr = arr.astype(arr.dtype.newbyteorder("="))
            variables[name] = arr
            dims[name] = tuple(var.dimensions)
        time = None
        if "time" in f.variables:
            tvar = f.variables["time"]
            time = decode_noleap_times(
                np.array(tvar.data),
                _attr_str(tvar, "units", "days since 1950-01-01"),
                _attr_str(tvar, "calendar", "noleap"),
            )
        return NcFile(variables, dims, time)
    finally:
        f.close()


_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def _import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing netCDF4 (HDF5) needs h5py, which is not "
            "installed; netCDF3 and CDF-5 files need only numpy and scipy"
        ) from e
    return h5py


def _decode_attr(v, default=""):
    if v is None:
        return default
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray):  # h5py may return 0-d / 1-element arrays
        v = v.reshape(-1)[0]
        return v.decode() if isinstance(v, bytes) else str(v)
    return str(v)


def _open_h5(path: str) -> NcFile:
    """netCDF4 (HDF5) reader through h5py, with the netCDF4 dimension-scale
    convention: coordinate variables are HDF5 dimension scales, and every
    data variable's axes reference them.  Flat files (root group only)."""
    h5py = _import_h5py()

    variables: Dict[str, np.ndarray] = {}
    dims: Dict[str, Tuple[str, ...]] = {}
    time = None
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            variables[name] = np.asarray(ds[...])
            if _decode_attr(ds.attrs.get("CLASS")) == "DIMENSION_SCALE":
                dims[name] = (name,)
                continue
            axes = []
            for i in range(ds.ndim):
                label = ""
                attached = list(ds.dims[i].values())
                if attached:
                    label = attached[0].name.rsplit("/", 1)[-1]
                axes.append(label or ds.dims[i].label or f"phony_dim_{i}")
            dims[name] = tuple(axes)
        if "time" in f:
            t = f["time"]
            time = decode_noleap_times(
                variables["time"],
                _decode_attr(t.attrs.get("units"), "days since 1950-01-01"),
                _decode_attr(t.attrs.get("calendar"), "noleap"),
            )
    return NcFile(variables, dims, time)


def native_disabled() -> bool:
    """Whether NISWAN_NO_NATIVE_NC=1 turns the native reader off."""
    return os.environ.get("NISWAN_NO_NATIVE_NC") == "1"


def open_nc(path: str) -> NcFile:
    """Open a netCDF file, dispatching on its magic bytes: netCDF3 classic
    -> the native reader, then scipy (CDF-1/2); HDF5 (netCDF4) -> h5py."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:3] == b"CDF":
        if not native_disabled():
            from nasa_niswan_tpu_torch.data.ncio_native import open_nc_native

            f = open_nc_native(path)  # C++ mmap reader (native/nc3read.cpp)
            if f is not None:
                return f
        return _open_scipy(path)
    if magic == _HDF5_MAGIC:
        return _open_h5(path)
    raise ValueError(
        f"{path}: not netCDF3 classic or HDF5/netCDF4 (magic {magic!r})"
    )


def write_nc(
    path: str,
    dim_sizes: Mapping[str, int],
    variables: Mapping[str, Tuple[Sequence[str], np.ndarray]],
    *,
    time_values: Optional[np.ndarray] = None,
    time_units: str = "hours since 1950-01-01",
    calendar: str = "noleap",
    fmt: str = "netcdf3",
) -> str:
    """Write a netCDF file: fmt "netcdf3" (scipy classic), "netcdf4" (h5py
    with the dimension-scale convention) or "cdf5" (64-bit-data classic, a
    record layout with an unlimited time dim).

    ``variables`` maps name -> (dims, array).  When ``time_values`` is
    given, a CF time coordinate with the no-leap calendar is written, as in
    the ModelE files the readers expect.
    """
    if fmt == "netcdf4":
        return _write_h5(
            path, dim_sizes, variables, time_values=time_values,
            time_units=time_units, calendar=calendar,
        )
    if fmt == "cdf5":
        return _write_cdf5(
            path, dim_sizes, variables, time_values=time_values,
            time_units=time_units, calendar=calendar,
        )
    if fmt != "netcdf3":
        raise ValueError(f"unknown fmt {fmt!r}")
    from scipy.io import netcdf_file

    with netcdf_file(path, "w") as f:
        for name, size in dim_sizes.items():
            f.createDimension(name, size)
        if time_values is not None:
            if "time" not in dim_sizes:
                f.createDimension("time", len(time_values))
            tv = f.createVariable("time", "d", ("time",))
            tv[:] = np.asarray(time_values, dtype=np.float64)
            tv.units = time_units.encode()
            tv.calendar = calendar.encode()
        for name, (dims, arr) in variables.items():
            arr = np.asarray(arr)
            v = f.createVariable(name, arr.dtype.str.lstrip("<>|"), tuple(dims))
            v[:] = arr
    return path


def _write_h5(
    path, dim_sizes, variables, *, time_values, time_units, calendar
) -> str:
    """netCDF4-style HDF5 writer: one dimension-scale dataset per dim (time
    carries CF units/calendar attributes); data variables attach the scales
    axis by axis."""
    h5py = _import_h5py()

    sizes = dict(dim_sizes)
    if time_values is not None and "time" not in sizes:
        sizes["time"] = len(time_values)
    # an explicit coordinate variable (name == its only dim) becomes the
    # scale itself, e.g. a raw fractional-year time axis
    coord_vars = {
        n for n, (dims, _a) in variables.items() if dims == (n,)
    }
    with h5py.File(path, "w") as f:
        scales = {}
        for name, size in sizes.items():
            if name in coord_vars:
                ds = f.create_dataset(
                    name, data=np.asarray(variables[name][1], np.float64)
                )
            elif name == "time" and time_values is not None:
                ds = f.create_dataset(
                    name, data=np.asarray(time_values, np.float64)
                )
                ds.attrs["units"] = time_units
                ds.attrs["calendar"] = calendar
            else:
                ds = f.create_dataset(name, data=np.arange(size, dtype=np.float64))
            ds.make_scale(name)
            scales[name] = ds
        for name, (dims, arr) in variables.items():
            if name in coord_vars:
                continue
            arr = np.asarray(arr)
            v = f.create_dataset(name, data=arr)
            for i, d in enumerate(dims):
                v.dims[i].attach_scale(scales[d])
    return path


_CDF5_TYPES = {
    "int8": 1, "S1": 2, "int16": 3, "int32": 4, "float32": 5, "float64": 6,
    "uint8": 7, "uint16": 8, "uint32": 9, "int64": 10, "uint64": 11,
}


def _write_cdf5(
    path, dim_sizes, variables, *, time_values, time_units, calendar,
    record_dim: Optional[str] = None,
) -> str:
    """CDF-5 (64-bit data) writer, per the classic format specification with
    the PnetCDF extensions: magic CDF\\x05, every NON_NEG field 64-bit, the
    unsigned/64-bit types.  When ``time_values`` is given the time dim is
    UNLIMITED and time-led variables are laid out record-interleaved.  Read
    back by the native reader (native/nc3read.cpp)."""
    import struct

    def pad4(n: int) -> int:
        return (n + 3) & ~3

    sizes = dict(dim_sizes)
    vars_out: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    numrecs = 0
    if time_values is not None:
        tv = np.asarray(time_values, np.float64)
        numrecs = len(tv)
        record_dim = record_dim or "time"
        sizes.setdefault("time", numrecs)
        vars_out["time"] = (("time",), tv)
    elif record_dim is not None:
        # an explicit record dim without a time coordinate; its length sets
        # numrecs
        numrecs = int(sizes[record_dim])
    for name, (dims, arr) in variables.items():
        vars_out[name] = (tuple(dims), np.asarray(arr))
        if record_dim is not None and dims and dims[0] == record_dim:
            if vars_out[name][1].shape[0] != numrecs:
                raise ValueError(
                    f"{name}: leading ({record_dim}) dim "
                    f"{vars_out[name][1].shape[0]} != numrecs {numrecs}"
                )
    dim_names = list(sizes)
    dim_ids = {n: i for i, n in enumerate(dim_names)}

    def nc_type(a: np.ndarray) -> int:
        key = "S1" if a.dtype.kind == "S" else a.dtype.name
        if key not in _CDF5_TYPES:
            raise ValueError(f"dtype {a.dtype} not representable in CDF-5")
        return _CDF5_TYPES[key]

    def name_bytes(s: str) -> bytes:
        b = s.encode()
        return struct.pack(">q", len(b)) + b + b"\x00" * (pad4(len(b)) - len(b))

    # (name, dims, arr, is_record, vsize, unpadded_bytes) per variable; vsize
    # per the spec: full size for fixed vars, per-record for record vars,
    # padded to 4
    metas = []
    for name, (dims, arr) in vars_out.items():
        is_rec = record_dim is not None and len(dims) > 0 and dims[0] == record_dim
        data_shape = arr.shape[1:] if is_rec else arr.shape
        nbytes = int(np.prod(data_shape, dtype=np.int64)) * arr.dtype.itemsize
        metas.append((name, dims, arr, is_rec, pad4(nbytes), nbytes))

    def header(begin_of) -> bytes:
        out = bytearray(b"CDF\x05")
        out += struct.pack(">q", numrecs)
        out += struct.pack(">i", 0x0A) + struct.pack(">q", len(dim_names))
        for n in dim_names:
            out += name_bytes(n)
            out += struct.pack(">q", 0 if n == record_dim else int(sizes[n]))
        out += struct.pack(">iq", 0, 0)  # gatt_list ABSENT
        out += struct.pack(">i", 0x0B) + struct.pack(">q", len(metas))
        for name, dims, arr, _rec, vsize, _nb in metas:
            out += name_bytes(name)
            out += struct.pack(">q", len(dims))
            for d in dims:
                out += struct.pack(">q", dim_ids[d])
            atts = (
                [("units", time_units), ("calendar", calendar)]
                if name == "time"
                else []
            )
            if atts:
                out += struct.pack(">i", 0x0C) + struct.pack(">q", len(atts))
                for an, av in atts:
                    b = av.encode()
                    out += name_bytes(an)
                    out += struct.pack(">iq", 2, len(b))
                    out += b + b"\x00" * (pad4(len(b)) - len(b))
            else:
                out += struct.pack(">iq", 0, 0)
            out += struct.pack(">i", nc_type(arr))
            out += struct.pack(">q", vsize)
            out += struct.pack(">q", begin_of[name])
        return bytes(out)

    hdr_len = len(header({m[0]: 0 for m in metas}))
    begin_of: Dict[str, int] = {}
    off = pad4(hdr_len)
    for name, _dims, arr, is_rec, _vsize, _nb in metas:
        if not is_rec:
            begin_of[name] = off
            off += pad4(arr.nbytes)
    recvars = [m for m in metas if m[3]]
    # format special case: a sole record variable is NOT padded
    recsize = (
        recvars[0][5] if len(recvars) == 1 else sum(m[4] for m in recvars)
    )
    for m in recvars:
        begin_of[m[0]] = off
        off += m[4] if len(recvars) > 1 else m[5]

    def be_bytes(a: np.ndarray) -> bytes:
        if a.dtype.kind == "S":
            return a.tobytes()
        return a.astype(a.dtype.newbyteorder(">"), copy=False).tobytes()

    with open(path, "wb") as fh:
        fh.write(header(begin_of))
        for name, _dims, arr, is_rec, vsize, nb in metas:
            if not is_rec:
                fh.seek(begin_of[name])
                fh.write(be_bytes(arr))
        for r in range(numrecs):
            for name, _dims, arr, is_rec, _vsize, _nb in metas:
                if is_rec:
                    fh.seek(begin_of[name] + r * recsize)
                    fh.write(be_bytes(np.asarray(arr[r])))
        # files are sized to the last written byte; no trailing pad needed
    return path
