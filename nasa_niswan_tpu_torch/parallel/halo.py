"""Halo exchange for spatially sharded grids (counterpart of
nasa_niswan_tpu/parallel/halo.py), over ``torch.distributed``.

Every conv of a sharded ConvLSTM needs k//2 rows and columns of its
neighbours' tiles.  ``halo_exchange_zero`` extends a rank's (B, h, w, C)
tile to (B, h + 2p, w + 2p, C) with them: the neighbours' data inside the
domain, zeros beyond its edge, so a SAME conv of the extended tile, cropped
(or a VALID conv, ``sharded_conv2d``), equals the single-device SAME conv
of the whole grid on the tile's pixels.  ``halo_exchange_geo`` wraps in
longitude instead (cyclic, a ring), zeros toward the poles.

As in the JAX package, longitude is extended first and latitude second, on
the lon-extended tile, so the corners come from the diagonal neighbours
with no message of their own.  Per axis each rank sends its edge strips to
its two neighbours with one ``batch_isend_irecv`` on contiguous buffers (a
column strip of an NHWC tile is not contiguous, so it is copied); a strip
that would only be zeroed at the domain edge is not sent.  Along an axis of
one rank nothing is sent: the tile wraps (cyclic) or gets zeros.  With two
ranks the left and the right neighbour are one rank: the two messages carry
distinct tags (gloo matches by tag) and are issued in one order on both
sides (NCCL matches by order).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.parallel.mesh import Mesh

_TAG_HI, _TAG_LO = 1, 2  # a rank's high-index strip, its low-index strip


def _extend_axis(x: torch.Tensor, pad: int, dim: int, mesh: Mesh, axis: str, *,
                 cyclic: bool) -> torch.Tensor:
    """Extend ``dim`` of a tile by ``pad`` halo slots per side from the
    neighbours along mesh ``axis``; zeros at the domain edge unless
    ``cyclic``."""
    size = x.shape[dim]
    if pad > size:
        raise ValueError(f"halo {pad} exceeds local extent {size}")
    n, idx = mesh.size(axis), mesh.index(axis)
    lo = x.narrow(dim, 0, pad)
    hi = x.narrow(dim, size - pad, pad)
    if n == 1:
        if cyclic:
            lo_halo, hi_halo = hi, lo
        else:
            lo_halo, hi_halo = torch.zeros_like(lo), torch.zeros_like(hi)
        return torch.cat([lo_halo, x, hi_halo], dim=dim)
    # my low halo is my left neighbour's high strip, my high halo my right
    # neighbour's low strip; a halo at the domain edge is zero unless cyclic
    need_lo = cyclic or idx > 0
    need_hi = cyclic or idx < n - 1
    left, right = mesh.neighbor(axis, -1), mesh.neighbor(axis, 1)
    lo_halo, hi_halo = torch.zeros_like(lo), torch.zeros_like(hi)
    ops = []
    if need_hi:
        ops.append(dist.P2POp(dist.isend, hi.contiguous(), right, tag=_TAG_HI))
    if need_lo:
        ops.append(dist.P2POp(dist.isend, lo.contiguous(), left, tag=_TAG_LO))
        ops.append(dist.P2POp(dist.irecv, lo_halo, left, tag=_TAG_HI))
    if need_hi:
        ops.append(dist.P2POp(dist.irecv, hi_halo, right, tag=_TAG_LO))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([lo_halo, x, hi_halo], dim=dim)


def halo_exchange_zero(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                       lon_axis: int = 2) -> torch.Tensor:
    """(B, h, w, C) tile -> (B, h + 2p, w + 2p, C): neighbour halos inside
    the domain, zeros beyond its edge.  Every rank of the mesh calls it."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", cyclic=False)
    return _extend_axis(x, pad, lat_axis, mesh, "lat", cyclic=False)


def halo_exchange_geo(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                      lon_axis: int = 2) -> torch.Tensor:
    """Geo-topology halos: cyclic in longitude (a ring), zeros toward the
    poles."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", cyclic=True)
    return _extend_axis(x, pad, lat_axis, mesh, "lat", cyclic=False)


def sharded_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, pad: int, mesh: Mesh,
                   lat_axis: int = 1, lon_axis: int = 2) -> torch.Tensor:
    """The SAME (zero padding ``pad``) conv of the whole grid, on a rank's
    NHWC tile: halo exchange, then a VALID conv."""
    if pad:
        x = halo_exchange_zero(x, pad, mesh, lat_axis=lat_axis, lon_axis=lon_axis)
    return conv2d(x, kernel, bias, padding=0)
