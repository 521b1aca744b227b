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
``halo_exchange_geo``, ``halo_exchange_reflect`` and ``sharded_conv2d``
train.

``halo_exchange_reflect`` is the halo of pix2pix's reflect padding: the
neighbours' strips inside the domain, and at its edge the tile's own rows
1..p mirrored.

The UNet and the pix2pix generator halve the map at every level, so their
deep levels have tiles too small to cut.  The gather rule (``descend``,
its test ``halves``): a
level runs on tiles while every tile of the level above halves evenly and
stays at least 2 pixels on a side; from the first level that fails, the
map is gathered over lat and lon (``gather_map``) and the remaining levels
run whole on every rank, and the decoder cuts the map back to tiles at the
same level (``cut_map``).  The cut's backward places the tile's cotangent
in a zero map (slicing's own), the gather's sums the whole map's
cotangents over the (lat, lon) plane and keeps the tile's part: each rank's
whole levels then hold its tile's part of their parameter gradients, which
the step's all-reduce sums over lat and lon, as it sums the tiled levels'.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.parallel.mesh import Mesh, gather_tiles, local_tile

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
    neighbours along mesh ``axis``; at the domain edge ``edge`` says what
    the halo holds: "zero", "cyclic" (the far neighbour's strip) or
    "reflect" (the tile's own rows 1..pad mirrored, numpy's ``reflect``).

    The backward is the transposed exchange: each halo strip's cotangent
    goes back to the rank whose edge strip it was, which adds it onto that
    strip; a zero halo at the domain edge sends nothing back, a reflected
    one is added, mirrored, onto the rows it came from.  Its messages use
    the forward's tags, each naming the strip it belongs to on the
    receiving rank, and the forward's posting order."""

    @staticmethod
    def forward(ctx, x, pad: int, dim: int, mesh: Mesh, axis: str, edge: str):
        size = x.shape[dim]
        if pad > size - (edge == "reflect"):
            raise ValueError(f"halo {pad} ({edge}) exceeds local extent {size}")
        ctx.args = (pad, dim, mesh, axis, edge)
        n, idx = mesh.size(axis), mesh.index(axis)
        lo = x.narrow(dim, 0, pad)
        hi = x.narrow(dim, size - pad, pad)
        need_lo, need_hi = _needs(n, idx, edge)
        # my low halo is my left neighbour's high strip, my high halo my right
        # neighbour's low strip; at the domain edge it is made here
        lo_halo = torch.empty_like(lo) if need_lo else _edge_halo(x, pad, dim, edge, "lo")
        hi_halo = torch.empty_like(hi) if need_hi else _edge_halo(x, pad, dim, edge, "hi")
        if need_lo or need_hi:
            _exchange(mesh.neighbor(axis, -1), mesh.neighbor(axis, 1),
                      (hi.contiguous(), _TAG_HI) if need_hi else None,
                      (lo.contiguous(), _TAG_LO) if need_lo else None,
                      (lo_halo, _TAG_HI) if need_lo else None,
                      (hi_halo, _TAG_LO) if need_hi else None)
        return torch.cat([lo_halo, x, hi_halo], dim=dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pad, dim, mesh, axis, edge = ctx.args
        return _reduce_axis(g, pad, dim, mesh, axis, edge), None, None, None, None, None


def _needs(n: int, idx: int, edge: str) -> Tuple[bool, bool]:
    """Whether this rank's (low, high) halo comes from a neighbour: inside
    the domain, or round the ring when ``edge`` is cyclic; never along an
    axis of one rank."""
    if n == 1:
        return False, False
    cyclic = edge == "cyclic"
    return cyclic or idx > 0, cyclic or idx < n - 1


def _edge_halo(x: torch.Tensor, pad: int, dim: int, edge: str, side: str) -> torch.Tensor:
    """The ``side`` halo a tile at the domain edge makes itself."""
    size = x.shape[dim]
    if edge == "zero":
        return x.new_zeros((*x.shape[:dim], pad, *x.shape[dim + 1:]))
    if edge == "cyclic":  # an axis of one rank: the tile's own far strip
        return x.narrow(dim, size - pad, pad) if side == "lo" else x.narrow(dim, 0, pad)
    start = 1 if side == "lo" else size - 1 - pad
    return x.narrow(dim, start, pad).flip(dim)


def _reduce_axis(g: torch.Tensor, pad: int, dim: int, mesh: Mesh, axis: str,
                 edge: str) -> torch.Tensor:
    """The transpose of ``_ExtendAxis.forward``: (..., size + 2 pad, ...)
    cotangent of the extended tile -> (..., size, ...) of the tile."""
    size = g.shape[dim] - 2 * pad
    n, idx = mesh.size(axis), mesh.index(axis)
    g_lo_halo = g.narrow(dim, 0, pad)
    g_hi_halo = g.narrow(dim, size + pad, pad)
    out = g.narrow(dim, pad, size).clone()
    need_lo, need_hi = _needs(n, idx, edge)
    if need_lo or need_hi:
        # my low halo's cotangent belongs to my left neighbour's high strip,
        # my high halo's to my right neighbour's low strip
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
    # the halos this tile made itself at the domain edge
    if edge == "cyclic" and n == 1:
        out.narrow(dim, size - pad, pad).add_(g_lo_halo)
        out.narrow(dim, 0, pad).add_(g_hi_halo)
    elif edge == "reflect":
        if not need_lo:
            out.narrow(dim, 1, pad).add_(g_lo_halo.flip(dim))
        if not need_hi:
            out.narrow(dim, size - 1 - pad, pad).add_(g_hi_halo.flip(dim))
    return out


def _extend_axis(x: torch.Tensor, pad: int, dim: int, mesh: Mesh, axis: str, *,
                 edge: str) -> torch.Tensor:
    return _ExtendAxis.apply(x, pad, dim, mesh, axis, edge)


def halo_exchange_zero(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                       lon_axis: int = 2) -> torch.Tensor:
    """(B, h, w, C) tile -> (B, h + 2p, w + 2p, C): neighbour halos inside
    the domain, zeros beyond its edge.  Every rank of the mesh calls it."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", edge="zero")
    return _extend_axis(x, pad, lat_axis, mesh, "lat", edge="zero")


def halo_exchange_zero_transpose(g: torch.Tensor, pad: int, mesh: Mesh, *,
                                 lat_axis: int = 1, lon_axis: int = 2) -> torch.Tensor:
    """The transpose of ``halo_exchange_zero`` (its backward): the
    cotangent (B, h + 2p, w + 2p, C) of an extended tile -> (B, h, w, C) of
    the tile, each halo strip added onto the edge strip it came from.  The
    axes go in the forward's reverse order, lat then lon, so the corners
    come back through the diagonal neighbour's lon strip.  Every rank of
    the mesh calls it."""
    g = _reduce_axis(g, pad, lat_axis, mesh, "lat", "zero")
    return _reduce_axis(g, pad, lon_axis, mesh, "lon", "zero")


def halo_exchange_geo(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                      lon_axis: int = 2) -> torch.Tensor:
    """Geo-topology halos: cyclic in longitude (a ring), zeros toward the
    poles."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", edge="cyclic")
    return _extend_axis(x, pad, lat_axis, mesh, "lat", edge="zero")


def halo_exchange_reflect(x: torch.Tensor, pad: int, mesh: Mesh, *, lat_axis: int = 1,
                          lon_axis: int = 2) -> torch.Tensor:
    """Reflect-padding halos (pix2pix's 4x4 stride-2 convs): the
    neighbours' strips inside the domain, and at its edge the tile's own
    rows and columns 1..pad mirrored, so a VALID conv of the extended tile
    equals the whole grid's ``reflect_pad`` conv on the tile's pixels.  An
    edge tile needs more than ``pad`` rows and columns.  Its backward adds
    each halo's cotangent where the halo came from."""
    x = _extend_axis(x, pad, lon_axis, mesh, "lon", edge="reflect")
    return _extend_axis(x, pad, lat_axis, mesh, "lat", edge="reflect")


def sharded_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, pad: int, mesh: Mesh,
                   lat_axis: int = 1, lon_axis: int = 2) -> torch.Tensor:
    """The SAME (zero padding ``pad``) conv of the whole grid, on a rank's
    NHWC tile: halo exchange, then a VALID conv."""
    if pad:
        x = halo_exchange_zero(x, pad, mesh, lat_axis=lat_axis, lon_axis=lon_axis)
    return conv2d(x, kernel, bias, padding=0)


def halves(t: torch.Tensor) -> bool:
    """The gather rule: whether the (B, h, w, C) tiles of a level halve
    evenly into tiles of at least 2 pixels on a side, so the next level
    runs on tiles too."""
    h, w = t.shape[1:3]
    return h % 2 == 0 and w % 2 == 0 and h >= 4 and w >= 4


def descend(h: torch.Tensor, on_tiles: bool, mesh: Mesh) -> Tuple[torch.Tensor, bool]:
    """The gather rule on the way down from a level: (h, whether the next
    level runs on tiles), h gathered over the (lat, lon) plane where this
    level ran on tiles and the next runs whole."""
    nxt = on_tiles and halves(h)
    return (gather_map(h, mesh) if on_tiles and not nxt else h), nxt


class _GatherMap(torch.autograd.Function):
    """The (B, h, w, C) tiles of the (lat, lon) plane gathered into the
    (B, H, W, C) map on every rank of it; the backward sums the map's
    cotangents over the plane and keeps this tile's part."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return gather_tiles(x, mesh, lat_axis=1, lon_axis=2, batch_axis=None)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        if mesh.lat * mesh.lon > 1:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.groups["latlon"])
        return cut_map(g, mesh), None


def gather_map(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's tile of a (B, H, W, C) map -> the whole map on every rank
    of its (lat, lon) plane, differentiably.  Every rank calls it."""
    return _GatherMap.apply(x, mesh)


def cut_map(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A (B, H, W, C) map every rank of the plane holds -> this rank's tile
    (contiguous); the backward places the tile's cotangent in a zero map."""
    return local_tile(x, mesh, lat_axis=1, lon_axis=2, batch_axis=None).contiguous()
