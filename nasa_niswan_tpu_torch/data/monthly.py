"""Monthly-attributes merge (counterpart of nasa_niswan_tpu/data/monthly.py).

The reference joins monthly ModelE diagnostics (the ``xaijE33oma_ai``
family, a fractional-year time axis) onto the half-hourly training rows by
a host-side row merge on (lat, lon, month).  Here the monthly attributes
become one climatology table of shape (12, H, W, K), and each step indexes
it with its month number: ``merge_monthly`` is a gather, on whatever
device the table lives.  The readers are numpy; ``merge_monthly`` takes
numpy or torch and returns a tensor.
"""

from __future__ import annotations

import os
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# grid-cell area, land/ocean-ice/water/soil/vegetation/snow-ice fractions,
# water-table depth, sea-surface salinity, surface pressure, potential
# evaporation
MONTHLY_ATTRIBUTES: List[str] = [
    "axyp", "landfr", "oclkicefr", "pwatfr", "soilfr", "vsfr",
    "snowicefr", "wtbl_depth", "sss", "prsurfq", "pot_evap",
]

MONTHLY_FAMILY = "xaijE33oma_ai"


def fractional_year_to_date(fractional_year: float) -> datetime:
    """Fractional calendar year -> datetime under the 365-day approximation
    (1950.5 -> 1950-07-02 12:00)."""
    year = int(fractional_year)
    days = (fractional_year - year) * 365.0
    return datetime(year, 1, 1) + timedelta(days=days)


def load_monthly_attrs(
    root: str,
    names: Sequence[str] = tuple(MONTHLY_ATTRIBUTES),
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read every ``*.xaijE33oma_ai.nc`` under ``root`` (sorted), concatenate
    along time, and decode the fractional-year axis to month numbers.

    Returns ``(months, fields)``: months (N,) int 1..12; fields maps each
    requested attribute to its (N, H, W) array.
    """
    from nasa_niswan_tpu_torch.data.ncio import open_nc

    paths: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        paths += [
            os.path.join(dirpath, f)
            for f in files
            if MONTHLY_FAMILY in f and f.endswith(".nc")
        ]
    if not paths:
        raise FileNotFoundError(f"no {MONTHLY_FAMILY} files under {root}")
    months: List[int] = []
    parts: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    for p in sorted(paths):
        f = open_nc(p)
        # monthly files carry a raw fractional-year time variable
        tvals = np.atleast_1d(np.asarray(f["time"], np.float64))
        months += [fractional_year_to_date(v).month for v in tvals]
        for n in names:
            arr = np.asarray(f[n], np.float32)
            if arr.ndim == 2:  # single-record file without a time dim
                arr = arr[None]
            parts[n].append(arr)
    fields = {n: np.concatenate(parts[n], axis=0) for n in names}
    return np.asarray(months, np.int32), fields


def monthly_climatology(
    months: np.ndarray, fields: Dict[str, np.ndarray]
) -> np.ndarray:
    """(months, per-attr (N, H, W)) -> one (12, H, W, K) table, averaging
    records that share a calendar month.  Months with no record hold NaN,
    so indexing one shows up instead of reading zeros."""
    names = list(fields)
    N, H, W = fields[names[0]].shape
    table = np.full((12, H, W, len(names)), np.nan, np.float32)
    for m in range(1, 13):
        sel = months == m
        if sel.any():
            for k, n in enumerate(names):
                table[m - 1, ..., k] = fields[n][sel].mean(axis=0)
    return table


def month_index(time_index) -> np.ndarray:
    """Per-step 0-based month index from a sequence of timestamps (a
    ``TimeIndex`` or any iterable of datetimes)."""
    return np.asarray([t.month - 1 for t in time_index], np.int32)


def merge_monthly(
    table, month_idx, *, channels: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """The merge as a gather: for each step t, the attribute frame is
    ``table[month_idx[t]]``.

    table (12, H, W, K) numpy or tensor; month_idx (T,) 0-based.  Returns a
    (T, H, W, K) tensor (or the selected ``channels``) on the table's
    device.
    """
    tab = torch.as_tensor(table)
    if channels is not None:
        tab = tab[..., list(channels)]
    idx = torch.as_tensor(np.asarray(month_idx, np.int64), device=tab.device)
    return torch.index_select(tab, 0, idx)
