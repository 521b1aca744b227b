"""Process groups over a (dp, lat, lon) mesh of ranks (counterpart of
nasa_niswan_tpu/parallel/mesh.py).

The canonical mesh is the JAX package's ("dp", "lat", "lon"):

  dp   data parallel over the batch: the gradient all-reduce;
  lat  latitude rows of the padded grid;
  lon  longitude columns; its halo messages go round a ring.

Where JAX holds every device in one process, the port runs one process
(rank) per device: rank r uses ``cuda:r`` (``LOCAL_RANK`` under torchrun)
or the CPU.  ``init_distributed`` joins the rank to the process group, and
``make_mesh`` lays the ranks out as rank = (d * lat + i) * lon + j and makes
one process group per row of each axis, every rank creating every group in
one fixed order (``torch.distributed.new_group`` must be called by all
ranks).  The point-to-point halo messages (parallel/halo.py) address global
ranks; the gathers and the all-reduce use the axis groups.

``local_tile`` and ``gather_tiles`` take the place of JAX's shardings
(``replicated``, ``batch_sharded``, ``spatial_sharded``): a global tensor
that every rank holds is cut to the rank's tile, and tiles are gathered back
to the global tensor on every rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "lat", "lon")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def rank_device(device_type: str) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (the global rank when
    ``LOCAL_RANK`` is unset) or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(device_type, local)


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device_type: str = "cuda",
) -> int:
    """Join this process to the default process group; returns its rank.

    The backend is nccl for ``device_type`` cuda and gloo for cpu.  With
    no ``init_method`` the group is read from the environment (``env://``:
    torchrun's ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).  A process
    already in a group keeps it.  On cuda the rank's card becomes
    the current device (NCCL needs it before the first collective)."""
    if not dist.is_initialized():
        if device_type not in BACKENDS:
            raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                             f"got {device_type!r}")
        kwargs = {}
        if init_method is not None:
            kwargs = dict(world_size=world_size, rank=rank)
        dist.init_process_group(BACKENDS[device_type], init_method=init_method or "env://",
                                **kwargs)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, lat, lon) layout of the ranks, seen from one rank."""

    dp: int
    lat: int
    lon: int
    rank: int
    device: torch.device
    groups: Dict[str, object]  # axis -> this rank's process group on it

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.dp, self.lat, self.lon)

    @property
    def coords(self) -> Tuple[int, int, int]:
        d, rest = divmod(self.rank, self.lat * self.lon)
        return (d, *divmod(rest, self.lon))

    def size(self, axis: str) -> int:
        return getattr(self, axis)

    def index(self, axis: str) -> int:
        return self.coords[MESH_AXES.index(axis)]

    def rank_at(self, d: int, i: int, j: int) -> int:
        return (d * self.lat + i) * self.lon + j

    def neighbor(self, axis: str, step: int) -> int:
        """The global rank ``step`` places along ``axis``, cyclic."""
        c = list(self.coords)
        a = MESH_AXES.index(axis)
        c[a] = (c[a] + step) % self.shape[a]
        return self.rank_at(*c)


def make_mesh(dp: int = 1, lat: int = 1, lon: int = 1) -> Mesh:
    """The (dp, lat, lon) mesh over the ranks of the default process group,
    whose size must be dp * lat * lon, on the rank's own device
    (``rank_device`` of the backend's device type)."""
    world = dist.get_world_size()
    n = dp * lat * lon
    if n != world:
        raise ValueError(f"mesh {dp}x{lat}x{lon}={n} != world size {world}")
    rank = dist.get_rank()
    shape = (dp, lat, lon)
    groups = {}
    for a, axis in enumerate(MESH_AXES):
        # one group per row of the axis, in the same order on every rank
        others = [range(s) for b, s in enumerate(shape) if b != a]
        for u in others[0]:
            for v in others[1]:
                ranks = []
                for k in range(shape[a]):
                    c = [u, v]
                    c.insert(a, k)
                    ranks.append((c[0] * lat + c[1]) * lon + c[2])
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    nccl = dist.get_backend() == "nccl"
    device = rank_device("cuda" if nccl else "cpu")
    dist.barrier(device_ids=[device.index] if nccl else None)
    return Mesh(dp, lat, lon, rank, device, groups)


def _span(n_total: int, n: int, idx: int, what: str) -> slice:
    if n_total % n:
        raise ValueError(f"{what} extent {n_total} does not split evenly over {n} ranks")
    size = n_total // n
    return slice(idx * size, (idx + 1) * size)


def local_tile(x: torch.Tensor, mesh: Mesh, *, lat_axis: Optional[int] = None,
               lon_axis: Optional[int] = None, batch_axis: Optional[int] = 0) -> torch.Tensor:
    """This rank's tile of a global tensor: the batch axis cut over dp, the
    lat and lon axes over lat and lon (an axis given as None is kept
    whole).  A view; the caller makes it contiguous where it must be."""
    for dim, axis in ((batch_axis, "dp"), (lat_axis, "lat"), (lon_axis, "lon")):
        if dim is not None:
            sl = _span(x.shape[dim], mesh.size(axis), mesh.index(axis), axis)
            x = x.narrow(dim, sl.start, sl.stop - sl.start)
    return x


def gather_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's tile along one mesh axis, concatenated along ``dim`` in
    the axis's order, on every rank of the axis."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def gather_tiles(x: torch.Tensor, mesh: Mesh, *, lat_axis: Optional[int] = None,
                 lon_axis: Optional[int] = None,
                 batch_axis: Optional[int] = 0) -> torch.Tensor:
    """The inverse of ``local_tile``: the global tensor on every rank, the
    tiles gathered over lat, then lon, then dp."""
    for dim, axis in ((lat_axis, "lat"), (lon_axis, "lon"), (batch_axis, "dp")):
        if dim is not None:
            x = gather_axis(x, mesh, axis, dim)
    return x
