from nasa_niswan_tpu_torch.core.grid import MODELE_2x2P5, MODELE_2x2P5_L20, GridSpec
from nasa_niswan_tpu_torch.core.padding import (
    crop_to_grid,
    pad_cyclic_lon,
    pad_geo,
    pad_reflect_lat,
)
