"""Lat-lon grid specification for the ModelE 2 x 2.5 degree grid
(counterpart of nasa_niswan_tpu/core/grid.py; numpy only).

The emulator runs on a fixed 90 (lat) x 144 (lon) grid with a 30-minute
timestep, so 48 steps make one model day.  The padded input size, the output
crop offsets and the cos-lat metric weights all derive from it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A global regular lat-lon grid.

    Attributes:
      nlat: latitude rows (grid boxes pole to pole).
      nlon: longitude columns (wraps cyclically).
      nlev: vertical levels carried by the model (1 = surface only,
        20 = the 3-D fusion configuration).
      steps_per_day: model timesteps per day (30 min -> 48).
    """

    nlat: int = 90
    nlon: int = 144
    nlev: int = 1
    steps_per_day: int = 48

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nlat, self.nlon)

    @property
    def lat(self) -> np.ndarray:
        """Latitude box centers in degrees, south to north."""
        dlat = 180.0 / self.nlat
        return np.linspace(-90.0 + dlat / 2, 90.0 - dlat / 2, self.nlat)

    @property
    def lon(self) -> np.ndarray:
        """Longitude box centers in degrees in [-180, 180)."""
        dlon = 360.0 / self.nlon
        return np.linspace(-180.0 + dlon / 2, 180.0 - dlon / 2, self.nlon)

    def coslat_weights(self) -> np.ndarray:
        """cos(latitude) area weights, shape (nlat,)."""
        return np.cos(np.deg2rad(self.lat))

    def padded_shape(self, pad_lat: int, pad_lon: int) -> Tuple[int, int]:
        return (self.nlat + 2 * pad_lat, self.nlon + 2 * pad_lon)

    def crop_offsets(self, padded: Tuple[int, int]) -> Tuple[int, int]:
        """Offsets of the physical grid inside a symmetrically padded array:
        (padded - grid) // 2, e.g. 100x154 -> (5, 5)."""
        return ((padded[0] - self.nlat) // 2, (padded[1] - self.nlon) // 2)


MODELE_2x2P5 = GridSpec(nlat=90, nlon=144, nlev=1, steps_per_day=48)
MODELE_2x2P5_L20 = GridSpec(nlat=90, nlon=144, nlev=20, steps_per_day=48)
