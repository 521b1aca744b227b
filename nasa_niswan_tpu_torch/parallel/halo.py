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

The exchange differentiates: its backward is the transposed exchange
(``halo_exchange_zero_transpose`` for the zero halos), latitude first,
then longitude.  Each halo strip's cotangent goes back to the rank whose
edge strip it was and is added there; a zero halo at the domain edge sends
nothing, the cyclic lon ring wraps.  So ``halo_exchange_zero``,
``halo_exchange_geo`` and ``sharded_conv2d`` train.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.parallel.mesh import Mesh

_TAG_HI, _TAG_LO = 1, 2  # a rank's high-index strip, its low-index strip


def _exchange(left: int, right: int, send_right, send_left, recv_left, recv_right) -> None:
    """One ``batch_isend_irecv`` with the neighbours, each message a
    (buffer, tag) or None, posted in this order on every rank."""
    ops = []
    for op, peer, msg in ((dist.isend, right, send_right), (dist.isend, left, send_left),
                          (dist.irecv, left, recv_left), (dist.irecv, right, recv_right)):
        if msg is not None:
            ops.append(dist.P2POp(op, msg[0], peer, tag=msg[1]))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


class _ExtendAxis(torch.autograd.Function):
    """Extend ``dim`` of a tile by ``pad`` halo slots per side from the
    neighbours along mesh ``axis``; zeros at the domain edge unless
    ``cyclic``.

    The backward is the transposed exchange: each halo strip's cotangent
    goes back to the rank whose edge strip it was, which adds it onto that
    strip; a zero halo at the domain edge sends nothing back.  Its messages
    use the forward's tags, each naming the strip it belongs to on the
    receiving rank, and the forward's posting order."""

    @staticmethod
    def forward(ctx, x, pad: int, dim: int, mesh: Mesh, axis: str, cyclic: bool):
        size = x.shape[dim]
        if pad > size:
            raise ValueError(f"halo {pad} exceeds local extent {size}")
        ctx.args = (pad, dim, mesh, axis, cyclic)
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
        need_lo, need_hi = cyclic or idx > 0, cyclic or idx < n - 1
        lo_halo, hi_halo = torch.zeros_like(lo), torch.zeros_like(hi)
        _exchange(mesh.neighbor(axis, -1), mesh.neighbor(axis, 1),
                  (hi.contiguous(), _TAG_HI) if need_hi else None,
                  (lo.contiguous(), _TAG_LO) if need_lo else None,
                  (lo_halo, _TAG_HI) if need_lo else None,
                  (hi_halo, _TAG_LO) if need_hi else None)
        return torch.cat([lo_halo, x, hi_halo], dim=dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pad, dim, mesh, axis, cyclic = ctx.args
        return _reduce_axis(g, pad, dim, mesh, axis, cyclic), None, None, None, None, None


def _reduce_axis(g: torch.Tensor, pad: int, dim: int, mesh: Mesh, axis: str,
                 cyclic: bool) -> torch.Tensor:
    """The transpose of ``_ExtendAxis.forward``: (..., size + 2 pad, ...)
    cotangent of the extended tile -> (..., size, ...) of the tile."""
    size = g.shape[dim] - 2 * pad
    n, idx = mesh.size(axis), mesh.index(axis)
    g_lo_halo = g.narrow(dim, 0, pad)
    g_hi_halo = g.narrow(dim, size + pad, pad)
    out = g.narrow(dim, pad, size).clone()
    if n == 1:
        if cyclic:  # the halos were this tile's own far strips
            out.narrow(dim, size - pad, pad).add_(g_lo_halo)
            out.narrow(dim, 0, pad).add_(g_hi_halo)
        return out
    need_lo, need_hi = cyclic or idx > 0, cyclic or idx < n - 1
    # my low halo's cotangent belongs to my left neighbour's high strip, my
    # high halo's to my right neighbour's low strip
    d_lo, d_hi = torch.empty_like(g_lo_halo), torch.empty_like(g_hi_halo)
    _exchange(mesh.neighbor(axis, -1), mesh.neighbor(axis, 1),
              (g_hi_halo.contiguous(), _TAG_LO) if need_hi else None,
              (g_lo_halo.contiguous(), _TAG_HI) if need_lo else None,
              (d_lo, _TAG_LO) if need_lo else None,
              (d_hi, _TAG_HI) if need_hi else None)
    if need_lo:
        out.narrow(dim, 0, pad).add_(d_lo)
    if need_hi:
        out.narrow(dim, size - pad, pad).add_(d_hi)
    return out


def _extend_axis(x: torch.Tensor, pad: int, dim: int, mesh: Mesh, axis: str, *,
                 cyclic: bool) -> torch.Tensor:
    return _ExtendAxis.apply(x, pad, dim, mesh, axis, cyclic)


def halo_exchange_zero(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                       lon_axis: int = 2) -> torch.Tensor:
    """(B, h, w, C) tile -> (B, h + 2p, w + 2p, C): neighbour halos inside
    the domain, zeros beyond its edge.  Every rank of the mesh calls it."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", cyclic=False)
    return _extend_axis(x, pad, lat_axis, mesh, "lat", cyclic=False)


def halo_exchange_zero_transpose(g: torch.Tensor, pad: int, mesh: Mesh, *,
                                 lat_axis: int = 1, lon_axis: int = 2) -> torch.Tensor:
    """The transpose of ``halo_exchange_zero`` (its backward): the
    cotangent (B, h + 2p, w + 2p, C) of an extended tile -> (B, h, w, C) of
    the tile, each halo strip added onto the edge strip it came from.  The
    axes go in the forward's reverse order, lat then lon, so the corners
    come back through the diagonal neighbour's lon strip.  Every rank of
    the mesh calls it."""
    g = _reduce_axis(g, pad, lat_axis, mesh, "lat", False)
    return _reduce_axis(g, pad, lon_axis, mesh, "lon", False)


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
