"""Variable names of the 90-day packed file (counterpart of the
``PACKED_VARS`` of nasa_niswan_tpu/data/catalog.py; the daily-file catalog
waits for the netCDF readers)."""

from __future__ import annotations

from typing import Dict, Tuple

# per species `<name>_src` / `<name>_conc` (reference dataset.py:321-340)
PACKED_VARS: Dict[str, Tuple[str, str]] = {
    "seasalt": ("seasalt_src", "seasalt_conc"),
    "clay": ("clay_src", "clay_conc"),
    "bcb": ("bcb_src", "bcb_conc"),
}
