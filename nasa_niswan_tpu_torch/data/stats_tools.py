"""Offline statistics (counterpart of nasa_niswan_tpu/data/stats_tools.py,
a numpy copy).

Produces a ``variable_statistics.json``-shaped document (per-variable
mean/std/min/max in raw space, set1, and log10 space, set2) from any
in-memory data dict, so the normalization fixture can be regenerated for
new species or periods.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from nasa_niswan_tpu_torch.data.dataset import masked_log10

# data-dict key -> stats-file key (variable_statistics.json naming)
DEFAULT_KEY_MAP = {
    "u": "u",
    "v": "v",
    "omega": "w",
    "prec": "prec",
    "seasalt_src": "ss_src",
    "clay_src": "c_src",
    "bcb_src": "bc_src",
    "seasalt_conc": "ss_conc",
    "clay_conc": "c_conc",
    "bcb_conc": "bc_conc",
}


def _describe(arr: np.ndarray) -> Dict[str, float]:
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
    }


def compute_statistics(
    data: Dict[str, np.ndarray],
    *,
    key_map: Optional[Dict[str, str]] = None,
    surface_only: bool = True,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """{set1: {var: {mean,std,min,max}}, set2: ...} over the given fields;
    set2 applies the masked log10 (non-positive -> 0.0) first."""
    key_map = key_map or DEFAULT_KEY_MAP
    set1, set2 = {}, {}
    for data_key, stats_key in key_map.items():
        if data_key not in data:
            continue
        arr = np.asarray(data[data_key], dtype=np.float32)
        if surface_only and arr.ndim == 4:
            arr = arr[:, 0]
        set1[stats_key] = _describe(arr)
        set2[stats_key] = _describe(masked_log10(arr))
    return {"set1": set1, "set2": set2}


def write_statistics(stats: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(stats, f, indent=4)
    return path
