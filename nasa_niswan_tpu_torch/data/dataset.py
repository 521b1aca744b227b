"""Normalization constants (counterpart of the ``Normalizer`` and
``zscore_static`` of nasa_niswan_tpu/data/dataset.py).

The constants stay numpy float32 arrays, as in the JAX package, so one
set of statistics serves both packages; the methods take torch tensors and
compute with the same formulas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Z-score normalization constants (channel vectors for X, scalars for y)."""

    x_mean: np.ndarray  # (C,)
    x_std: np.ndarray  # (C,)
    y_mean: float
    y_std: float

    def normalize_x(self, x):
        """x: (..., C, H, W)."""
        mean = torch.as_tensor(self.x_mean, device=x.device).reshape(-1, 1, 1)
        std = torch.as_tensor(self.x_std, device=x.device).reshape(-1, 1, 1)
        return (x - mean) / std

    def normalize_y(self, y):
        return (y - self.y_mean) / self.y_std

    def unnormalize_y(self, y):
        """Invert target normalization: pred * y_std + y_mean."""
        return y * self.y_std + self.y_mean


def zscore_static(static: np.ndarray) -> np.ndarray:
    """Z-score static attribute channels (C, H, W) over (lat, lon)."""
    mean = static.mean(axis=(1, 2), keepdims=True)
    std = static.std(axis=(1, 2), keepdims=True)
    return ((static - mean) / std).astype(np.float32)
