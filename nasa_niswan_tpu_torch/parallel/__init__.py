"""Multi-device execution over ``torch.distributed`` (counterpart of
nasa_niswan_tpu/parallel/): the (dp, lat, lon) mesh of ranks (mesh.py),
starting the ranks (launch.py), halo exchange and its transpose (halo.py),
spatially sharded serving and training (spatial.py) and data-parallel
training (dp.py)."""

from nasa_niswan_tpu_torch.parallel.halo import (
    halo_exchange_geo,
    halo_exchange_zero,
    sharded_conv2d,
)
from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh
