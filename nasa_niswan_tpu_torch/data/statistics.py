"""Per-variable normalization statistics (counterpart of
nasa_niswan_tpu/data/statistics.py, a copy).

``variable_statistics.json`` is a copy of the JAX package's: per-variable
mean/std/min/max over year-1950 ModelE output; ``set1`` is raw space,
``set2`` log10 space (used when ``transform`` is on).
"""

from __future__ import annotations

import dataclasses
import json
from importlib import resources
from typing import Dict, Tuple

import numpy as np

SPECIES = ("seasalt", "clay", "bcb")

# species -> (source stats key, concentration stats key)
_SPECIES_KEYS = {
    "seasalt": ("ss_src", "ss_conc"),
    "clay": ("c_src", "c_conc"),
    "bcb": ("bc_src", "bc_conc"),
}

# the dynamic input channels, in the reference's channel order: u, v,
# omega (w), precipitation; the species source comes last
DYNAMIC_VARS = ("u", "v", "w", "prec")


@dataclasses.dataclass(frozen=True)
class VariableStats:
    mean: float
    std: float
    min: float
    max: float


def load_statistics(path: str | None = None) -> Dict[str, Dict[str, VariableStats]]:
    """Load {set1|set2: {var: VariableStats}} from JSON (packaged by default)."""
    if path is None:
        text = (
            resources.files("nasa_niswan_tpu_torch.data")
            .joinpath("variable_statistics.json")
            .read_text()
        )
    else:
        with open(path) as f:
            text = f.read()
    raw = json.loads(text)
    return {
        set_name: {var: VariableStats(**vals) for var, vals in set_vals.items()}
        for set_name, set_vals in raw.items()
    }


def species_stats(
    species: str, *, transform: bool = False, path: str | None = None
) -> Tuple[np.ndarray, np.ndarray, VariableStats]:
    """Channel-ordered (mean, std) vectors for the 5 dynamic inputs plus the
    target-concentration stats for ``species``; ``transform`` selects the
    log10-space stats (set2).  Returns (x_mean (5,), x_std (5,), y_stats)."""
    if species not in SPECIES:
        raise ValueError(f"unknown species {species!r}; expected one of {SPECIES}")
    stats = load_statistics(path)["set2" if transform else "set1"]
    src_key, conc_key = _SPECIES_KEYS[species]
    keys = list(DYNAMIC_VARS) + [src_key]
    x_mean = np.array([stats[k].mean for k in keys], dtype=np.float32)
    x_std = np.array([stats[k].std for k in keys], dtype=np.float32)
    return x_mean, x_std, stats[conc_key]
