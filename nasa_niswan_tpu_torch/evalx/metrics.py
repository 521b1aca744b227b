"""Evaluation metrics on torch tensors (counterpart of
nasa_niswan_tpu/evalx/metrics.py, the reference's acceptance criteria):

  r2            sklearn r2_score on flattened arrays (train.py:114); its
                sufficient statistics r2_stats / r2_from_stats
  r2_temporal   per-timestep R^2 over flattened maps (test.ipynb cell 12)
  r2_spatial    per-gridpoint R^2 over time, 1 - ss_res/ss_tot (cell 16)
  pearson_r     scipy.stats.pearsonr statistic (cell 22)
  cos-lat weighted means and GT-weighted band-averaged R^2 (cells 22-24, 44)
  regional boxes (cell 38) and exceedance curves (Weibull, cell 29)

Every function takes tensors or numpy arrays; numpy inputs are computed in
f32, as the JAX package computes them (64-bit off), on the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# ModelE mixing ratios in 1e-2 kg/kg -> ug/kg display units (test.ipynb
# cell 17)
KGKG_TO_UGKG = 0.01

# Named evaluation regions (test.ipynb cell 38), degrees: (lat_lo, lat_hi),
# (lon_lo, lon_hi) in [-180, 180).
REGIONS: Dict[str, Dict[str, Tuple[float, float]]] = {
    "Amazon": {"lat": (-15.0, 5.0), "lon": (-75.0, -45.0)},
    "North Africa": {"lat": (10.0, 30.0), "lon": (-20.0, 50.0)},
    "Central Africa": {"lat": (-20.0, 10.0), "lon": (10.0, 40.0)},
    "Indonesia": {"lat": (-10.0, 10.0), "lon": (95.0, 140.0)},
    "Siberia": {"lat": (50.0, 70.0), "lon": (60.0, 130.0)},
    "Northern Canada": {"lat": (50.0, 70.0), "lon": (-140.0, -60.0)},
    "Atlantic Ocean": {"lat": (-20.0, 10.0), "lon": (-40.0, 10.0)},
    "Pacific Ocean": {"lat": (-20.0, 10.0), "lon": (-180.0, -80.0)},
}


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, np.float32 if a.dtype == np.float64 else a.dtype))


def r2(y_true, y_pred) -> torch.Tensor:
    """Coefficient of determination on flattened inputs (sklearn r2_score
    semantics: residuals vs variance around the true mean)."""
    y_true = _t(y_true).reshape(-1)
    y_pred = _t(y_pred).reshape(-1)
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    return 1.0 - ss_res / ss_tot


def r2_stats(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """R^2's sufficient statistics on flattened tensors, (ss_res, sum y,
    sum y^2, n) in f32: summed over batches or ranks, ``r2_from_stats`` of
    the sums is the R^2 of all the values together."""
    yf, pf = y_true.reshape(-1).float(), y_pred.reshape(-1).float()
    # n filled on the device: a host scalar would be a host-to-device copy,
    # which a captured step may not hold
    return torch.stack([torch.sum((yf - pf) ** 2), torch.sum(yf), torch.sum(yf * yf),
                        yf.new_full((), float(yf.numel()))])


def r2_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """R^2 from ``r2_stats``: 1 - ss_res / (sum y^2 - (sum y)^2 / n)."""
    ss_res, s_y, s_y2, n = stats
    return 1.0 - ss_res / (s_y2 - s_y * s_y / n)


def r2_temporal(y_true, y_pred) -> torch.Tensor:
    """Per-timestep R^2: axis 0 is time, each step's map flattened.
    Returns (T,)."""
    y_true = _t(y_true)
    y_true = y_true.reshape(y_true.shape[0], -1)
    y_pred = _t(y_pred).reshape(y_true.shape[0], -1)
    ss_res = torch.sum((y_true - y_pred) ** 2, dim=1)
    ss_tot = torch.sum((y_true - torch.mean(y_true, dim=1, keepdim=True)) ** 2, dim=1)
    return 1.0 - ss_res / ss_tot


def r2_spatial(y_true, y_pred) -> torch.Tensor:
    """Per-gridpoint R^2 over time.  Input (T, ..., H, W), reduces axis 0;
    returns (..., H, W)."""
    y_true, y_pred = _t(y_true), _t(y_pred)
    ss_res = torch.sum((y_true - y_pred) ** 2, dim=0)
    ss_tot = torch.sum((y_true - torch.mean(y_true, dim=0)) ** 2, dim=0)
    return 1.0 - ss_res / ss_tot


def pearson_r(a, b) -> torch.Tensor:
    a = _t(a).reshape(-1)
    b = _t(b).reshape(-1)
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    return torch.sum(a * b) / torch.sqrt(torch.sum(a * a) * torch.sum(b * b))


def coslat_weighted_mean(field, lat, *, lat_axis: int = -2, also_lon: bool = False):
    """cos(lat)-weighted mean over latitude (and optionally longitude),
    xarray's ``.weighted(cos(lat)).mean()``."""
    field = _t(field)
    w = torch.cos(torch.deg2rad(_t(lat)))
    shape = [1] * field.dim()
    shape[lat_axis] = -1
    wb = w.reshape(shape)
    num = torch.sum(field * wb, dim=lat_axis)
    den = torch.sum(wb.expand(field.shape), dim=lat_axis)
    out = num / den
    if also_lon:
        out = torch.mean(out, dim=-1)
    return out


def lat_band_weighted_r2(r2_map, weight_map, lat, band: Tuple[float, float]) -> torch.Tensor:
    """GT-magnitude-weighted mean R^2 over a latitude band (weight = the
    time-mean ground truth; band average = sum(w*r2)/sum(w))."""
    lat = np.asarray(lat)
    sel = torch.from_numpy((lat >= band[0]) & (lat <= band[1]))
    r2_map = _t(r2_map)[..., sel, :]
    weight_map = _t(weight_map)[..., sel, :]
    return torch.sum(weight_map * r2_map) / torch.sum(weight_map)


def regional_slice(field, lat, lon, region: str) -> torch.Tensor:
    """Slice (..., lat, lon) to a named region box."""
    box = REGIONS[region]
    lat, lon = np.asarray(lat), np.asarray(lon)
    lat_sel = torch.from_numpy((lat >= box["lat"][0]) & (lat <= box["lat"][1]))
    lon_sel = torch.from_numpy((lon >= box["lon"][0]) & (lon <= box["lon"][1]))
    return _t(field)[..., lat_sel, :][..., lon_sel]


def exceedance_curve(values) -> Tuple[np.ndarray, np.ndarray]:
    """Weibull plotting-position exceedance probabilities: values sorted
    descending, ep_i = 100 * i / (n + 1)."""
    v = -np.sort(-np.asarray(values).ravel())
    ep = 100.0 * np.arange(1, len(v) + 1) / (len(v) + 1)
    return v, ep


def random_sampling(data, n_samples: int = 10000, seed: int = 48) -> np.ndarray:
    """Deterministic flat subsample (test.ipynb cell 27)."""
    flat = np.asarray(data).ravel()
    idx = np.arange(flat.size)
    np.random.default_rng(seed).shuffle(idx)
    return flat[idx[:n_samples]]
