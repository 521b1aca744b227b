"""netCDF-tree loaders for real ModelE output (counterpart of
nasa_niswan_tpu/data/netcdf.py, a numpy copy on the port's ``pad_geo``,
``masked_log10`` and ``Normalizer``).

The lazy daily-file datasets of the reference, E33OMA (single step) and
E33OMA_CRNN (sequences), plus ``pack_to_npz``, which converts a tree of
daily netCDF files into one packed array file once; training then uses the
in-memory ``SequenceDataset`` / ``SingleStepDataset``.  Each day file is
read once into an LRU cache (``_DayCache``), not once per sample.  I/O goes
through data/ncio (the native reader, scipy, h5py for netCDF4), with no
pandas or xarray; time axes are ``ncio.TimeIndex``.
"""

from __future__ import annotations

import collections
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import pad_geo
from nasa_niswan_tpu_torch.data.catalog import FILE_FAMILIES, SPECIES_VARS, daily_filename
from nasa_niswan_tpu_torch.data.dataset import Normalizer, masked_log10, zscore_static
from nasa_niswan_tpu_torch.data import ncio_native as nat
from nasa_niswan_tpu_torch.data.ncio import NcFile, native_disabled, open_nc, write_nc
from nasa_niswan_tpu_torch.data.statistics import species_stats


def list_velocity_files(root: str) -> List[str]:
    """All daily velocity files under ``root``, sorted by date."""
    out: List[str] = []
    for dirpath, _, files in os.walk(root):
        out.extend(
            osp.join(dirpath, f)
            for f in sorted(files)
            if f.split(".")[1:2] == [f"{FILE_FAMILIES['velocity']}E33oma_ai"]
        )
    return sorted(out)


def _read_time_axis(path: str):
    """Decoded time index of one file.  The native reader reads only the
    time variable (a velocity day file is ~120 MB, its time axis 384
    bytes); the other backends read the whole file."""
    if not native_disabled() and nat.available():
        d = nat.read_vars(path, [])
        if d is not None and "time" in d:
            return d["time"]
    return open_nc(path).time


def _read_family_vars(
    path: str, names: List[str], *, levels: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Targeted read of ``names`` (+ decoded "time") from one day file:
    native partial reads when available (with ``levels`` restricting
    level-dimensioned variables to their first k levels at the byte
    level), the whole file through open_nc otherwise."""
    if not native_disabled() and nat.available():
        d = nat.read_vars(path, names, levels=levels)
        if d is not None:
            # read_vars omits "time" when the axis is absent/unreadable;
            # normalize to the open_nc contract (time=None) so consumers
            # see a consistent shape instead of a bare KeyError
            d.setdefault("time", None)
            return d
    f = open_nc(path)
    out = {n: f[n] for n in names}
    out["time"] = f.time
    f.close()
    return out


def load_time_index(root: str):
    """Time index over the whole tree (no-leap calendar dates on the
    proleptic-Gregorian axis), a ``TimeIndex``."""
    parts = []
    for path in list_velocity_files(root):
        t = _read_time_axis(path)
        if t is None:
            raise ValueError(f"velocity file {path} has no time coordinate")
        parts.append(t)
    if not parts:
        raise FileNotFoundError(f"no velocity files under {root}")
    return parts[0].append(parts[1:]) if len(parts) > 1 else parts[0]


def open_day(root: str, date_yyyymmdd: str, family_key: str) -> NcFile:
    return open_nc(osp.join(root, daily_filename(date_yyyymmdd, family_key)))


def read_day_fields(
    root: str, date_yyyymmdd: str, species: str, *, levels: int | None = None
) -> Dict[str, np.ndarray]:
    """Read one day of all model inputs/targets into numpy arrays.

    levels=None -> surface only (the reference's isel(level=0));
    levels=k -> first k vertical levels (the 20-level fusion config).
    Level axis is 1 in the 4-D families (time, level, lat, lon).
    """
    sv = SPECIES_VARS[species]
    lev = (lambda a: a[:, 0]) if levels is None else (lambda a: a[:, :levels])
    path = lambda fam: osp.join(root, daily_filename(date_yyyymmdd, fam))
    # targeted reads: only the variables this species/config consumes
    # (a taijlh1 file carries all three species' concentrations), and
    # only the consumed levels (surface = 1 of 20)
    nlev = 1 if levels is None else levels
    vel = _read_family_vars(path("velocity"), ["u", "v", "omega"], levels=nlev)
    pre = _read_family_vars(path("precip"), ["prec"])
    src = _read_family_vars(path(sv.src_family), [sv.src_var])
    trc = _read_family_vars(path("tracer_conc"), [sv.conc_var], levels=nlev)
    return {
        "u": lev(vel["u"]).astype(np.float32),
        "v": lev(vel["v"]).astype(np.float32),
        "omega": lev(vel["omega"]).astype(np.float32),
        "prec": pre["prec"].astype(np.float32),
        "src": src[sv.src_var].astype(np.float32),
        "conc": lev(trc[sv.conc_var]).astype(np.float32),
        "time": vel["time"],
    }


class _DayCache:
    """Small LRU of per-day field dicts: each netCDF file in a window is
    opened and decoded once, not once per sample."""

    def __init__(self, root: str, species: str, maxsize: int = 4):
        self.root = root
        self.species = species
        self._cache: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()
        self.maxsize = maxsize

    def day(self, date_yyyymmdd: str) -> Dict[str, np.ndarray]:
        if date_yyyymmdd in self._cache:
            self._cache.move_to_end(date_yyyymmdd)
            return self._cache[date_yyyymmdd]
        fields = read_day_fields(self.root, date_yyyymmdd, self.species)
        self._cache[date_yyyymmdd] = fields
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
        return fields

    def frame_index(self, date_yyyymmdd: str, t) -> int:
        times = self.day(date_yyyymmdd)["time"]
        return int(np.argmin(np.abs(times - t)))  # int64 nanoseconds


def pack_to_npz(
    root: str,
    out_path: str,
    species: str = "bcb",
    *,
    dates: Optional[List[str]] = None,
    levels: int | None = None,
) -> str:
    """Offline packing: daily netCDF tree -> one compressed npz slab keyed
    like the synthetic fixture (u, v, omega, prec, {species}_src/_conc).

    Run once per species; the packed file feeds SequenceDataset directly.
    """
    if dates is None:
        index = load_time_index(root)
        dates = sorted({t.strftime("%Y%m%d") for t in index})
    fields: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("u", "v", "omega", "prec", "src", "conc")
    }
    for d in dates:
        day = read_day_fields(root, d, species, levels=levels)
        for k in fields:
            fields[k].append(day[k])
    packed = {k: np.concatenate(v, axis=0) for k, v in fields.items()}
    np.savez_compressed(
        out_path,
        u=packed["u"],
        v=packed["v"],
        omega=packed["omega"],
        prec=packed["prec"],
        **{f"{species}_src": packed["src"], f"{species}_conc": packed["conc"]},
    )
    return out_path


def load_90days_nc(
    path: str, *, levels: int | None = None
) -> Dict[str, np.ndarray]:
    """Direct reader for a packed E33OMA-90Days.nc-style single file:
    variables u/v/omega (time[,level],
    lat,lon), prec, and ``{species}_src`` / ``{species}_conc`` for whichever
    species the file carries.  Returns the packed dict consumed by
    SequenceDataset / SingleStepDataset / fuse_levels.

    levels=None -> surface slice of the level-bearing variables (the
    reference's isel(level=0)); levels=k -> first k levels kept (feeds the
    fusion config, data/fusion.py).
    """
    f = open_nc(path)
    lev = (
        (lambda a, d: a[:, 0] if "level" in d else a)
        if levels is None
        else (lambda a, d: a[:, :levels] if "level" in d else a)
    )
    out: Dict[str, np.ndarray] = {}
    for name in f.data_vars:
        dims = f.dims[name]
        if "time" not in dims:
            continue
        out[name] = lev(f[name], dims).astype(np.float32)
    f.close()
    wanted = {"u", "v", "omega", "prec"}
    missing = wanted - out.keys()
    if missing:
        raise ValueError(f"{path} lacks variables {sorted(missing)}")
    return out


def load_static_attrs(path: str, *, exclude_prefix: str = "lai") -> np.ndarray:
    """static_attrs.nc -> (C, H, W) array, excluding ``lai_*`` variables
    (the reference's add_static_attributes)."""
    f = open_nc(path)
    chans = [
        f[name]
        for name in f.data_vars
        if name.split("_")[0] != exclude_prefix
    ]
    f.close()
    return np.asarray(chans, dtype=np.float32)


class LazyE33OMASingleStep:
    """Lazy daily-netCDF single-step dataset (the reference's E33OMA):
    deterministic shuffled 70/30 train/val split over
    the first model year, test = all of year 2; per sample reads the day's
    files (LRU-cached), extracts surface u/v/omega/prec + species source +
    target + previous-step concentration (the 6-channel feedback mode),
    normalizes from the shipped statistics JSON (set2 in log10 mode), pads
    geophysically.

    Reading netCDF per sample is slow: pack the tree once with pack_to_npz
    and train on the in-memory datasets; this class checks them against
    the real data tree.
    """

    def __init__(
        self,
        root: str,
        *,
        period: str,
        species: str = "bcb",
        in_channels: int = 5,
        transform: bool = False,
        padding: Optional[Tuple[int, int]] = (100, 154),
        train_frac: float = 0.7,
        seed: int = 0,
    ):
        self.root = root
        self.species = species
        self.in_channels = in_channels
        self.transform = transform
        self.padding = padding
        self._days = _DayCache(root, species)

        index = load_time_index(root)
        n = len(index) // 2  # first year
        # pairs (t, t-1): inputs/targets at t, feedback at t-1 (the first
        # and last steps drop out)
        cur = index[1:]
        prev = index[:-1]
        order = np.arange(n)
        np.random.default_rng(seed).shuffle(order)
        n_train = int(n * train_frac)
        if period == "train":
            sel = order[:n_train]
        elif period == "val":
            sel = order[n_train:]
        elif period == "test":
            sel = np.arange(n, len(cur))
        else:
            raise ValueError(f"bad period {period!r}")
        self.times = cur[sel]
        self.prev_times = prev[sel]
        self.normalizer = json_normalizer(species, transform=transform)
        _, _, y_stats = species_stats(species, transform=transform)
        self.y_mean, self.y_std = y_stats.mean, y_stats.std

    def __len__(self) -> int:
        return len(self.times)

    def __getitem__(self, i: int):
        t = self.times[i]
        day = t.strftime("%Y%m%d")
        fields = self._days.day(day)
        ti = self._days.frame_index(day, t)
        chans = [fields[k][ti] for k in ("u", "v", "omega", "prec", "src")]
        y = fields["conc"][ti]
        if self.in_channels == 6:
            tp = self.prev_times[i]
            pday = tp.strftime("%Y%m%d")
            pfields = self._days.day(pday)
            pi = self._days.frame_index(pday, tp)
            chans.append(pfields["conc"][pi])
        x = np.stack(chans).astype(np.float32)
        if self.transform:
            x = masked_log10(x)
            y = masked_log10(y)
        norm = self.normalizer
        x_mean = norm.x_mean
        x_std = norm.x_std
        if self.in_channels == 6:
            x_mean = np.concatenate([x_mean, [self.y_mean]])
            x_std = np.concatenate([x_std, [self.y_std]])
        x = (x - x_mean.reshape(-1, 1, 1)) / x_std.reshape(-1, 1, 1)
        y = (y - self.y_mean) / self.y_std
        if self.padding:
            x = _pad(x, self.padding)
        return x.astype(np.float32), y.astype(np.float32)


def _pad(x: np.ndarray, padding) -> np.ndarray:
    return pad_geo(torch.from_numpy(np.ascontiguousarray(x)), padding).numpy()


class LazyE33OMASequence:
    """Lazy daily-netCDF sequence dataset (the reference's E33OMA_CRNN):
    sliding windows over the full two-year index,
    train = year 1, val = next 10%, test = the rest; target at window end;
    stats from the shipped JSON (set1)."""

    def __init__(
        self,
        root: str,
        *,
        period: str,
        species: str = "bcb",
        sequence_length: int = 48,
        in_channels: int = 5,
        padding: Optional[Tuple[int, int]] = (100, 154),
        static_attrs_path: Optional[str] = None,
    ):
        self.root = root
        self.species = species
        self.seq_len = sequence_length
        self.in_channels = in_channels
        self.padding = padding
        self._days = _DayCache(root, species)

        index = load_time_index(root)
        windows = [
            index[i : i + sequence_length]
            for i in range(len(index) - sequence_length + 1)
        ]
        targets = index[sequence_length - 1 :]
        year = 17520 if len(targets) >= 17520 else int(len(targets) * 0.5)
        tenth = int(year * 0.1)
        sel = {
            "train": slice(0, year),
            "val": slice(year, year + tenth),
            "test": slice(year + tenth, None),
        }[period]
        self.windows = windows[sel]
        self.targets = targets[sel]
        self.normalizer = json_normalizer(species)
        _, _, y_stats = species_stats(species)
        self.y_mean, self.y_std = y_stats.mean, y_stats.std
        n_static = in_channels - 5
        if n_static > 0:
            if static_attrs_path is None:
                raise ValueError("static channels requested without attrs path")
            self.static = zscore_static(
                load_static_attrs(static_attrs_path)[:n_static]
            )
        else:
            self.static = None

    def __len__(self) -> int:
        return len(self.targets)

    def __getitem__(self, i: int):
        window = self.windows[i]
        frames = []
        for t in window:
            d = t.strftime("%Y%m%d")
            f = self._days.day(d)
            ti = self._days.frame_index(d, t)
            frames.append(
                np.stack([f[k][ti] for k in ("u", "v", "omega", "prec", "src")])
            )
        x = np.stack(frames).astype(np.float32)  # (T, 5, H, W)
        td = self.targets[i].strftime("%Y%m%d")
        tti = self._days.frame_index(td, self.targets[i])
        y = self._days.day(td)["conc"][tti].astype(np.float32)

        norm = self.normalizer
        x = (x - norm.x_mean.reshape(1, -1, 1, 1)) / norm.x_std.reshape(1, -1, 1, 1)
        y = (y - self.y_mean) / self.y_std
        if self.static is not None:
            tiled = np.broadcast_to(
                self.static[None], (x.shape[0], *self.static.shape)
            )
            x = np.concatenate([x, tiled], axis=1)
        if self.padding:
            x = _pad(x, self.padding)
        return x.astype(np.float32), y.astype(np.float32)


def build_static_attrs(
    land_cover_path: str,
    lai_path: str,
    grid_attrs_path: str,
    out_path: str,
    *,
    drop_all_zero: bool = True,
) -> str:
    """Offline static_attrs.nc builder: merges land-cover class fractions
    (dropping all-zero classes), LAI variables renamed ``lai_*``, and grid
    attributes (axyp/landfr/ocnfr) into one netCDF consumed by the
    static-channel loaders."""
    lc = open_nc(land_cover_path)
    lai = open_nc(lai_path)
    grid = open_nc(grid_attrs_path)

    out_vars: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for v in lc.data_vars:
        if drop_all_zero and float(np.abs(lc[v]).sum()) == 0.0:
            continue
        out_vars[v] = (lc.dims[v], lc[v])
    for v in lai.data_vars:
        out_vars[f"lai_{v}"] = (lai.dims[v], lai[v])
    for v in ("axyp", "landfr", "ocnfr"):
        if v in grid:
            out_vars[v] = (grid.dims[v], grid[v])

    dim_sizes: Dict[str, int] = {}
    for dims, arr in out_vars.values():
        for d, s in zip(dims, np.asarray(arr).shape):
            dim_sizes.setdefault(d, s)
    write_nc(out_path, dim_sizes, out_vars)
    for f in (lc, lai, grid):
        f.close()
    return out_path


def json_normalizer(species: str, *, transform: bool = False):
    """Normalizer from the shipped variable_statistics.json (the lazy
    datasets' normalization source)."""
    x_mean, x_std, y_stats = species_stats(species, transform=transform)
    return Normalizer(
        x_mean=x_mean, x_std=x_std, y_mean=y_stats.mean, y_std=y_stats.std
    )
