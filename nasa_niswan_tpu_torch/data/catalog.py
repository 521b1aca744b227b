"""ModelE output-file taxonomy and variable catalog (counterpart of
nasa_niswan_tpu/data/catalog.py, a copy).

The E33OMA run's five families of daily netCDF files are named
``YYYYMMDD.<family>E33oma_ai.nc``:

  aijlh1   velocity fields u, v, omega          (time, level, lat, lon)
  cijh1    precipitation ``prec``               (time, lat, lon)
  taijh1   sea-salt ocean source                (time, lat, lon)
  tNDaijh1 clay / BCB emissions                 (time, lat, lon)
  taijlh1  aerosol mixing ratios (targets)      (time, level, lat, lon)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

FILE_FAMILIES: Dict[str, str] = {
    "velocity": "aijlh1",
    "precip": "cijh1",
    "seasalt_src": "taijh1",
    "dust_src": "tNDaijh1",  # clay and BCB emissions
    "tracer_conc": "taijlh1",
}


@dataclasses.dataclass(frozen=True)
class SpeciesVars:
    src_family: str  # FILE_FAMILIES key holding the emission field
    src_var: str
    conc_var: str


SPECIES_VARS: Dict[str, SpeciesVars] = {
    "seasalt": SpeciesVars("seasalt_src", "seasalt1_ocean_src", "seasalt1"),
    "clay": SpeciesVars("dust_src", "Clay_emission", "Clay"),
    "bcb": SpeciesVars("dust_src", "BCB_biomass_src", "BCB"),
}

# variable names of the 90-day packed file: per species `<name>_src` /
# `<name>_conc` (reference dataset.py:321-340)
PACKED_VARS: Dict[str, Tuple[str, str]] = {
    "seasalt": ("seasalt_src", "seasalt_conc"),
    "clay": ("clay_src", "clay_conc"),
    "bcb": ("bcb_src", "bcb_conc"),
}


def daily_filename(date_yyyymmdd: str, family_key: str) -> str:
    return f"{date_yyyymmdd}.{FILE_FAMILIES[family_key]}E33oma_ai.nc"
