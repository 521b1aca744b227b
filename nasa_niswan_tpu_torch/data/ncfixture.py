"""Synthetic daily-netCDF fixture tree: the ModelE E33OMA schema without
NASA data (counterpart of nasa_niswan_tpu/data/ncfixture.py, a copy).

Writes the five daily-file families the ingestion path reads
(catalog.FILE_FAMILIES):

  YYYYMMDD.aijlh1E33oma_ai.nc    u, v, omega      (time, level, lat, lon)
  YYYYMMDD.cijh1E33oma_ai.nc     prec             (time, lat, lon)
  YYYYMMDD.taijh1E33oma_ai.nc    seasalt1_ocean_src
  YYYYMMDD.tNDaijh1E33oma_ai.nc  BCB_biomass_src, Clay_emission
  YYYYMMDD.taijlh1E33oma_ai.nc   BCB, Clay, seasalt1 (time, level, lat, lon)

with a CF no-leap time coordinate, so the lazy loaders, the packer and the
calendar decoding run end to end without the real tree.  Files are netCDF3
classic by default; fmt="netcdf4" writes HDF5 (needs h5py) and fmt="cdf5"
the 64-bit-data classic format.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import numpy as np

from nasa_niswan_tpu_torch.data.catalog import daily_filename
from nasa_niswan_tpu_torch.data.ncio import decode_noleap_times, write_nc

_STEP_UNITS = "hours since 1950-01-01"


def write_fixture_tree(
    root: str,
    *,
    days: int = 4,
    steps_per_day: int = 8,
    H: int = 10,
    W: int = 16,
    levels: int = 3,
    seed: int = 0,
    start_hours: float = 0.0,
    fmt: str = "netcdf3",
) -> Dict[str, np.ndarray]:
    """Write ``days`` daily file sets under ``root``; returns the full
    concatenated field arrays (for oracle comparison in tests):
    u/v/omega/{BCB,Clay,seasalt1} as (T, L, H, W), prec and the three
    sources as (T, H, W), plus ``time`` (the decoded ``TimeIndex``)."""
    rng = np.random.default_rng(seed)
    T = days * steps_per_day
    f4 = lambda: rng.standard_normal((T, levels, H, W)).astype(np.float32)
    f3 = lambda: rng.standard_normal((T, H, W)).astype(np.float32)
    fields = {
        "u": f4(),
        "v": f4(),
        "omega": f4(),
        "prec": np.abs(f3()),
        "BCB_biomass_src": np.abs(f3()),
        "Clay_emission": np.abs(f3()),
        "seasalt1_ocean_src": np.abs(f3()),
        "BCB": np.abs(f4()),
        "Clay": np.abs(f4()),
        "seasalt1": np.abs(f4()),
    }
    step_h = 24.0 / steps_per_day
    hours = start_hours + np.arange(T) * step_h
    times = decode_noleap_times(hours, _STEP_UNITS, "noleap")

    os.makedirs(root, exist_ok=True)
    dims4 = ("time", "level", "lat", "lon")
    dims3 = ("time", "lat", "lon")
    for d in range(days):
        sl = slice(d * steps_per_day, (d + 1) * steps_per_day)
        date = times[sl.start].strftime("%Y%m%d")
        common = dict(
            time_values=hours[sl], time_units=_STEP_UNITS, calendar="noleap",
            fmt=fmt,
        )
        dsize = {"time": steps_per_day, "level": levels, "lat": H, "lon": W}
        write_nc(
            osp.join(root, daily_filename(date, "velocity")), dsize,
            {k: (dims4, fields[k][sl]) for k in ("u", "v", "omega")}, **common,
        )
        write_nc(
            osp.join(root, daily_filename(date, "precip")), dsize,
            {"prec": (dims3, fields["prec"][sl])}, **common,
        )
        write_nc(
            osp.join(root, daily_filename(date, "seasalt_src")), dsize,
            {"seasalt1_ocean_src": (dims3, fields["seasalt1_ocean_src"][sl])},
            **common,
        )
        write_nc(
            osp.join(root, daily_filename(date, "dust_src")), dsize,
            {
                "BCB_biomass_src": (dims3, fields["BCB_biomass_src"][sl]),
                "Clay_emission": (dims3, fields["Clay_emission"][sl]),
            },
            **common,
        )
        write_nc(
            osp.join(root, daily_filename(date, "tracer_conc")), dsize,
            {k: (dims4, fields[k][sl]) for k in ("BCB", "Clay", "seasalt1")},
            **common,
        )
    fields["time"] = times
    return fields


def write_static_attrs_inputs(
    root: str, *, H: int = 10, W: int = 16, seed: int = 1
) -> Dict[str, str]:
    """Write the three input files of the static-attrs builder: land-cover
    class fractions (one all-zero class to exercise the drop), LAI
    variables, and grid attrs.  Returns their paths."""
    rng = np.random.default_rng(seed)
    dims = ("lat", "lon")
    dsize = {"lat": H, "lon": W}
    f = lambda: rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)

    paths = {
        "land_cover": osp.join(root, "land_cover.nc"),
        "lai": osp.join(root, "lai.nc"),
        "grid": osp.join(root, "grid_attrs.nc"),
    }
    os.makedirs(root, exist_ok=True)
    write_nc(
        paths["land_cover"], dsize,
        {
            "ent1": (dims, f()),
            "ent2": (dims, f()),
            "ent_zero": (dims, np.zeros((H, W), np.float32)),
        },
    )
    write_nc(paths["lai"], dsize, {"ent1": (dims, f()), "ent2": (dims, f())})
    write_nc(
        paths["grid"], dsize,
        {"axyp": (dims, f()), "landfr": (dims, f()), "ocnfr": (dims, f())},
    )
    return paths


def write_monthly_fixture(
    root: str,
    *,
    months: int = 12,
    start_year: int = 1950,
    H: int = 10,
    W: int = 16,
    seed: int = 2,
    fmt: str = "netcdf3",
) -> Dict[str, np.ndarray]:
    """Write a ``xaijE33oma_ai`` monthly-means tree: one file per month, 11
    attribute variables, and a raw fractional-year time value (mid-month,
    365-day calendar, read without decoding).  Returns the oracle
    arrays: each attribute (months, H, W) plus the month numbers."""
    from nasa_niswan_tpu_torch.data.monthly import MONTHLY_ATTRIBUTES

    rng = np.random.default_rng(seed)
    month_days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    dims = ("time", "lat", "lon")
    os.makedirs(root, exist_ok=True)
    out = {n: rng.standard_normal((months, H, W)).astype(np.float32)
           for n in MONTHLY_ATTRIBUTES}
    month_no = np.empty(months, np.int32)
    for m in range(months):
        year = start_year + m // 12
        mo = m % 12
        month_no[m] = mo + 1
        frac = year + (sum(month_days[:mo]) + month_days[mo] / 2) / 365.0
        name = f"{year}{mo + 1:02d}.xaijE33oma_ai.nc"
        write_nc(
            osp.join(root, name),
            {"time": 1, "lat": H, "lon": W},
            {"time": (("time",), np.array([frac], np.float64)),
             **{n: (dims, out[n][m : m + 1]) for n in MONTHLY_ATTRIBUTES}},
            fmt=fmt,
        )
    out["month"] = month_no
    return out
