"""The port's configuration and normalizer types, built from a configuration
file and the seeded statistics, and the deltas of its launch counters
(``nasa_niswan_tpu_torch.ops.launch_counts``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig


def convlstm_config(config: dict) -> ConvLSTMConfig:
    """The serving configuration (training builds its model with
    ``models.registry.build_model``)."""
    return ConvLSTMConfig(
        in_channels=config["in_channels"],
        hidden_channels=tuple(config["hidden_channels"]),
        kernel_sizes=tuple(config["kernel_sizes"]),
        compute_dtype=config["compute_dtype"],
    )


def normalizer(stats: Dict[str, object]) -> Normalizer:
    return Normalizer(x_mean=np.asarray(stats["x_mean"], np.float32),
                      x_std=np.asarray(stats["x_std"], np.float32),
                      y_mean=float(stats["y_mean"]), y_std=float(stats["y_std"]))


def count_deltas(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()}
