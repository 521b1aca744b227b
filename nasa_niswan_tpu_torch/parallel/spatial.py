"""Spatially sharded serving (counterpart of the shard_map half of
nasa_niswan_tpu/parallel/spatial.py): BASELINE config #5, the decadal
multi-tracer rollout with the padded grid cut into (lat, lon) tiles over
the ranks of a mesh, and the sharded closed loop of config #3.

Each rank holds one tile of the padded domain, (h, w) = (H / lat, W / lon),
and the per-layer (h, c) carry of that tile for the whole run.  A cell step
on the tile (``cell_on_tile``, the counterpart of ``_pallas2_cell_sharded``):

  1. exchange k//2 rows and columns of halo of xh = [x; h] in the compute
     dtype with the neighbours (parallel/halo.py: one message per
     direction and axis, where the JAX package sends x and h apart);
  2. pad c with a zero ring;
  3. run the fused cell (``ops/convlstm_cell.fused_cell_forward``: kernel
     B1 on the card, its plain version on the CPU) on the (B, h + 2p,
     w + 2p) tile;
  4. crop the ring off h' and c'.

The extended tile's inner pixels read only tile and halo data, so each
equals the whole grid's cell at that pixel; a 1x1 cell runs on the tile as
it is.  The time loop is ``models/convlstm.convlstm_apply`` with that cell.
Normalization and ``pad_geo`` need the global frame, so every rank prepares
the whole raw chunk and takes its tile; the head's per-step taps are
gathered over lat, lon and dp at the end of the chunk, so a rollout returns
the global (B, T, h, w) predictions on every rank.  The closed loop needs
each step's prediction on the whole grid (its ``pad_geo`` wraps and
mirrors it): the tap tiles are gathered over lat, then lon, cropped,
padded and cut again, as ``spatial.py:615-623`` does.  The carry stays on
its tile; ``gather_state`` and ``scatter_state`` turn it into the global
carry of a carry file and back.

On a card each serving chunk is one CUDA graph replay, as every unsharded
serving chunk is (graph.py): the chunk's device work (``body``:
preparation, the time loop with its halo messages and gathers, head, crop)
is captured once per input signature and replayed; its inputs (the raw
chunk and the tile carry moved to the card) are made outside the graph, and
the packed B1 images before the capture.  The warm-up run before a capture
goes through one step of the chunk, so every halo exchange and gather of a
step (every layer, both axes) has made its NCCL communicator before the
capture.  On a one-rank axis nothing is sent and ``gather_axis`` returns
its tile, so one card captures the tile path, the ring, the crops and the
gathers' shapes but no NCCL message.  On the CPU (gloo) the chunks run
eagerly.

Training (``make_spatial_train_step``, the counterpart of the JAX
package's GSPMD step) takes every family.  The UNet and the pix2pix
generator run on the tile through ``ModelBundle.apply(tiles=True)``
(models/unet.py, models/pix2pix.py: halos of parallel/halo.py, norms
over the mesh, the gather rule).  The ConvLSTM runs the same cells on the
tile with gradients, by the single-device step's routes (``config.remat``
and the hoist):

* per-cell: ``_TileCell``, the halo exchange, ``FusedCell``'s VJP on the
  extended tile (B1 emit_gates forward; the elementwise backward, B3 and
  B2's dW kernel backward) and the crop as one autograd Function.  The
  zero ring on (dh, dc) makes the ring's gate cotangents zero, so the
  extended tile's dW holds only this tile's pixels; the transposed
  exchange adds the halo strips' cotangents to B3's f32 dxh before its one
  cast to the compute dtype, and the step hands it the f32 kernels, so
  each tile's weight gradient is summed over the steps and the tiles in
  f32 (the single-device per-cell route sums the steps' bf16 dW in bf16,
  as JAX's ``_v2_bwd`` does);
* the hoist (``precompute_input_conv``, per cell whatever ``remat`` says):
  ``_TileHoistedConv`` exchanges k//2 rows and columns of halo of all
  T * B normalized frames at once, runs B3 on the extended stack and crops
  the ring while rounding to the compute dtype; its backward is the dW
  kernel over the extended frames with the zero-ringed cotangent (the
  tile's part, f32 until the all-reduce; the input takes no gradient).
  Layer 0 is a ``_TileCell`` with the tile's xg slice: h's halo (the
  k 5 ``w_h`` conv), the zero ring on xg, B1's xg and emit_gates modes on
  the extended tile, dxg the cropped gate cotangent; layers 1-2 as
  per-cell;
* whole-scan BPTT: ``ops/convlstm_bptt.scan_cells`` with the tile cell and
  ``_tile_grads``, its per-cell backward on the tile: xh exchanged, c, dh
  and dc padded with the zero ring, ``ops/convgrad.cell_grads`` (B2, then
  B3) on the extended tile, the transposed exchange applied to dxh and the
  ring cropped off dc_prev.

Evaluation (``make_spatial_eval_step``) runs the same forwards without
grad, the hoist through the same tile conv, so xg is rounded as the
single-device forward rounds it.

The loss (MSE + L1 over the cropped grid) is the global mean: each rank
sums over its tile's part of the crop window and divides by its dp share's
pixel count, and ``parallel/dp.reduce_gradients`` sums the gradients, the
loss and R^2's statistics over lat and lon and averages over dp, in one
all-reduce; every rank then takes the same Adam step.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import (
    DeviceConst,
    Normalizer,
    make_preprocess_fn,
    zscore_static,
)
from nasa_niswan_tpu_torch.evalx.metrics import r2_from_stats, r2_stats
from nasa_niswan_tpu_torch.graph import Graphed
from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    GradsFn,
    cell_weights,
    convlstm_apply,
    head_apply,
)
from nasa_niswan_tpu_torch.models.registry import ModelBundle
from nasa_niswan_tpu_torch.ops.convgrad import cell_grads, conv_dw, conv_same
from nasa_niswan_tpu_torch.ops.convlstm_bptt import cells_step, combined_cells
from nasa_niswan_tpu_torch.ops.convlstm_cell import (
    _cell_vjp,
    fused_cell_forward,
    fused_cell_gates,
    join_xh,
)
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import fb_channel
from nasa_niswan_tpu_torch.parallel.dp import reduce_gradients
from nasa_niswan_tpu_torch.parallel.halo import halo_exchange_zero, halo_exchange_zero_transpose
from nasa_niswan_tpu_torch.parallel.mesh import Mesh, gather_axis, gather_tiles, local_tile
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    _prep_frame,
    first_step,
    flat_state,
    nest_state,
    serving_weights,
)
from nasa_niswan_tpu_torch.rollout.multitracer import (
    _species,
    _species_weights,
    _stack_states,
)
from nasa_niswan_tpu_torch.train.graph import graph_step
from nasa_niswan_tpu_torch.train.loop import host_batch, per_sample_r2_score


def cell_on_tile(xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 mesh: Mesh, cell_fn: CellFn = fused_cell_forward,
                 xg: Optional[torch.Tensor] = None):
    """One fused cell step on a rank's tile: xh (B, h, w, Cin) = [x; h] in
    the compute dtype, or the pair (x, h) joined in w's (h alone with the
    hoisted gates ``xg`` (B, h, w, 4 hid) of the tile), c (B, h, w, hid)
    f32; returns the tile's (h', c').  ``cell_fn`` is the cell run on the extended tile without grad (a
    test passes the plain version); ``xg`` gets the zero ring.  Under grad
    (the per-cell training route) the step is ``_TileCell``, B1's
    emit_gates mode on the extended tile."""
    xh = join_xh(xh, w.dtype)
    ins = (xh, c, w, b) if xg is None else (xh, c, w, b, xg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _TileCell.apply(xh, c, w, b, mesh, w.detach().to(xh.dtype), xg)
    p = w.shape[0] // 2
    if p == 0:
        return cell_fn(*ins)
    hl, wl = xh.shape[1:3]
    ext = (halo_exchange_zero(xh, p, mesh), _ring(c, p), w, b)
    h2, c2 = cell_fn(*ext) if xg is None else cell_fn(*ext, _ring(xg, p))
    return _crop(h2, p, hl, wl), _crop(c2, p, hl, wl)


def _ring(t: torch.Tensor, p: int) -> torch.Tensor:
    """A zero ring of ``p`` pixels around a (B, h, w, C) tile."""
    return F.pad(t, (0, 0, p, p, p, p))


def _crop(t: torch.Tensor, p: int, hl: int, wl: int) -> torch.Tensor:
    return t[:, p:p + hl, p:p + wl].contiguous()


class _TileCell(torch.autograd.Function):
    """``cell_on_tile`` around the per-cell VJP of ``FusedCell`` (with
    ``xg``, the hoisted layer 0's ``FusedCellXg``), as one Function.  The
    forward exchanges xh's halo, pads c (and xg) with the zero ring, runs
    B1's emit_gates mode (with xg, its xg mode too) on the extended tile
    with ``w_low``, the kernel ``w`` in xh's dtype, and crops: the launches
    of ``FusedCell`` on the extended tile.  The backward puts the zero ring
    on (dh, dc), so the ring's gate cotangents are zero, runs ``FusedCell``'s
    backward there (the elementwise backward, B3 for dxh, B2's dW kernels),
    applies the transposed exchange to B3's f32 dxh and casts the sum to
    xh's dtype once, so a halo pixel's cotangents from the neighbours are
    added in f32, as the whole-scan route's ``_tile_grads`` adds them.  dxg
    is the tile's gate cotangent.  dw is returned in ``w``'s dtype: given
    the f32 kernel, the tile's weight gradient is summed over the steps,
    and then over the tiles, in f32."""

    @staticmethod
    def forward(ctx, xh, c, w, b, mesh, w_low, xg=None):
        p = w.shape[0] // 2
        hl, wl = xh.shape[1:3]
        xe = halo_exchange_zero(xh, p, mesh) if p else xh
        ce = _ring(c, p)
        h2, c2, gates = fused_cell_gates(xe, ce, w_low, b, None if xg is None else _ring(xg, p))
        ctx.save_for_backward(xe, ce, gates, w_low)
        ctx.mesh, ctx.w_dtype, ctx.xg = mesh, w.dtype, xg is not None
        return _crop(h2, p, hl, wl), _crop(c2, p, hl, wl)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dc):
        xe, ce, gates, w_low = ctx.saved_tensors
        p = w_low.shape[0] // 2
        hl, wl = xe.shape[1] - 2 * p, xe.shape[2] - 2 * p
        dgates, dxe, dc_prev, dw, db = _cell_vjp(xe, ce, gates, w_low, _ring(dh, p),
                                                 _ring(dc, p), ctx.needs_input_grad[0])
        dxh = None
        if dxe is not None:
            dxh = (halo_exchange_zero_transpose(dxe, p, ctx.mesh) if p else dxe).to(xe.dtype)
        dxg = _crop(dgates, p, hl, wl) if ctx.xg else None
        return dxh, _crop(dc_prev, p, hl, wl), dw.to(ctx.w_dtype), db, None, None, dxg


class _TileHoistedConv(torch.autograd.Function):
    """The hoisted input conv on a rank's tile: x (N, h, w, C) = every
    frame of the tile (N = T * B) in the compute dtype, ``w`` layer 0's
    ``w_x``, ``w_low`` it in x's dtype.  The forward exchanges k//2 rows
    and columns of halo of the whole stack at once (one message per
    direction and axis), runs B3 (``conv_same``) on the extended (N, h +
    2p, w + 2p, C) stack and crops the ring off its f32 output while
    rounding it to x's dtype, so the extended output lives only as long as
    the conv.  The backward puts the zero ring on the cotangent and runs
    B2's dW kernel (``conv_dw``) with the extended stack: the tile's part of
    dw, returned in ``w``'s dtype (f32 for the f32 parameter, summed over
    the tiles by the step's all-reduce before any rounding).  The input
    takes no gradient."""

    @staticmethod
    def forward(ctx, x, w, mesh, w_low):
        if ctx.needs_input_grad[0]:
            raise ValueError("the hoisted conv on a tile takes no input gradient")
        p = w.shape[0] // 2
        hl, wl = x.shape[1:3]
        xe = halo_exchange_zero(x, p, mesh) if p else x
        ctx.save_for_backward(xe)
        ctx.k, ctx.w_dtype = w.shape[0], w.dtype
        return conv_same(xe, w_low)[:, p:p + hl, p:p + wl].to(x.dtype).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (xe,) = ctx.saved_tensors
        dw = conv_dw(xe, _ring(g.contiguous(), ctx.k // 2), ctx.k)
        return None, dw.to(ctx.w_dtype), None, None


def _hoist_on_tile(mesh: Mesh, config: ConvLSTMConfig):
    """``convlstm_apply``'s ``hoist_fn`` on a rank's tile: (w_x0, x (B, T,
    h, w, C)) -> xg (T, B, h, w, 4 hid0) of the tile in the compute dtype,
    through ``_TileHoistedConv``."""
    dt = config.torch_dtype

    def hoist(w, x):
        B, T, hl, wl, C = x.shape
        flat = x.transpose(0, 1).reshape(T * B, hl, wl, C).to(dt).contiguous()
        xg = _TileHoistedConv.apply(flat, w, mesh, w.detach().to(dt).contiguous())
        return xg.reshape(T, B, hl, wl, -1)
    return hoist


def _tile_cell(mesh: Mesh, cell_fn: CellFn = fused_cell_forward) -> CellFn:
    def cell(xh, c, w, b, xg=None):
        return cell_on_tile(xh, c, w, b, mesh, cell_fn, xg)
    return cell


def _tile_grads(mesh: Mesh) -> GradsFn:
    """The per-cell backward of the whole-scan BPTT on a rank's tile
    (``cell_grads`` on the extended tile): xh (B, h, w, Cin) and c, dh, dc
    (B, h, w, hid) of the tile in, the tile's (dxh, dc_prev) and this
    tile's part of (dw, db) out."""
    def grads(xh, c, dh, dc, w, b):
        p = w.shape[0] // 2
        if p == 0:
            return cell_grads(xh, c, dh, dc, w, b)
        hl, wl = xh.shape[1:3]

        # zeros: no cotangent reaches the ring from outside the tile
        dxh, dc_prev, dw, db = cell_grads(halo_exchange_zero(xh, p, mesh), _ring(c, p),
                                          _ring(dh, p), _ring(dc, p), w, b)
        return halo_exchange_zero_transpose(dxh, p, mesh), _crop(dc_prev, p, hl, wl), dw, db
    return grads


def _tile(x: torch.Tensor, mesh: Mesh, lat_axis: Optional[int] = None,
          batch_axis: Optional[int] = None) -> torch.Tensor:
    """``local_tile`` with lon the axis after lat."""
    return local_tile(x, mesh, lat_axis=lat_axis,
                      lon_axis=None if lat_axis is None else lat_axis + 1,
                      batch_axis=batch_axis)


def zero_tile_state(config: ConvLSTMConfig, batch: int, padded_shape, mesh: Mesh):
    """Zero per-layer (h, c) carry of this rank's tile, (batch, h, w, hidden)."""
    H, W = padded_shape
    shape = (batch, H // mesh.lat, W // mesh.lon)
    return [(torch.zeros((*shape, hc), device=mesh.device),
             torch.zeros((*shape, hc), device=mesh.device))
            for hc in config.hidden_channels]


def scatter_state(state, mesh: Mesh, *, batch_axis: Optional[int] = 0) -> list:
    """A global per-layer carry (every leaf (..., B, H, W, hidden), the
    batch at ``batch_axis`` or None for a carry every dp rank shares) ->
    this rank's tiles, contiguous f32 on the mesh's device."""
    lat = 1 if batch_axis is None else batch_axis + 1
    return [tuple(_tile(torch.as_tensor(t, device=mesh.device), mesh, lat, batch_axis)
                  .float().contiguous() for t in hc)
            for hc in state]


def gather_state(state, mesh: Mesh, *, batch_axis: Optional[int] = 0) -> list:
    """The inverse of ``scatter_state``: the global carry on every rank
    (every rank of the mesh calls it)."""
    lat = 1 if batch_axis is None else batch_axis + 1
    return [tuple(gather_tiles(t, mesh, lat_axis=lat, lon_axis=lat + 1,
                               batch_axis=batch_axis) for t in hc)
            for hc in state]


def _state_inputs(state, device, zeros) -> list:
    """A tile carry as a chunk's flat state inputs: ``zeros()`` when
    ``state`` is None, else its leaves as contiguous f32 on ``device``."""
    if state is None:
        return flat_state(zeros())
    return [torch.as_tensor(t, device=device).float().contiguous() for t in flat_state(state)]


def _scan_tile(params, weights, x, state, config: ConvLSTMConfig, cell: CellFn):
    """The stacked cells over a chunk of tiles (x (B, T, h, w, C), or a
    tuple of parts concatenated per step) with the tile cell ``cell``:
    (per-step head taps (B, T, h, w) of the tile, final carry)."""
    dt = config.torch_dtype
    _, taps, state = convlstm_apply(
        params, x, config, return_per_step=True, initial_state=state,
        return_state=True, tap_fn=lambda h: head_apply(params, h, dt)[..., 0],
        cell_fn=cell, weights=weights,
    )
    return taps, state


def _check_tiles(padded_shape, mesh: Mesh) -> None:
    H, W = padded_shape
    if H % mesh.lat or W % mesh.lon:
        raise ValueError(f"the padded grid {H}x{W} does not tile evenly over "
                         f"(lat, lon) = ({mesh.lat}, {mesh.lon})")


def convlstm_apply_sharded(params, x: torch.Tensor, config: ConvLSTMConfig,
                           mesh: Mesh, *, precompute_input_conv: bool = False
                           ) -> torch.Tensor:
    """Sharded ConvLSTM forward: x (B, T, H, W, C) on the padded domain,
    the whole tensor on every rank; returns this rank's tile of the
    (B, H, W, 1) prediction (batch over dp, grid over lat and lon), equal
    to ``convlstm_apply``'s there (with the hoisted input conv, its conv
    on the tile: the same bf16 rounding of xg).  Without grad."""
    _check_tiles(x.shape[2:4], mesh)
    with torch.inference_mode():
        x_t = _tile(torch.as_tensor(x, device=mesh.device), mesh, 2, 0)
        return convlstm_apply(
            params, x_t, config, precompute_input_conv=precompute_input_conv,
            cell_fn=_tile_cell(mesh), weights=cell_weights(params, config, precompute_input_conv),
            hoist_fn=_hoist_on_tile(mesh, config))


def _crop_window(padded_shape, grid_shape, mesh: Mesh):
    """This tile's part of the crop window of ``crop_to_grid``: (rows,
    cols) of the tile, (rows, cols) of the grid, as slices."""
    parts = []
    for axis, n_pad, n_grid in (("lat", padded_shape[0], grid_shape[0]),
                                ("lon", padded_shape[1], grid_shape[1])):
        size = n_pad // mesh.size(axis)
        start, off = mesh.index(axis) * size, (n_pad - n_grid) // 2
        lo, hi = max(start, off), min(start + size, off + n_grid)
        hi = max(lo, hi)
        parts.append((slice(lo - start, hi - start), slice(lo - off, hi - off)))
    (tr, gr), (tc, gc) = parts
    return (tr, tc), (gr, gc)


def _per_cell_tiles(params, x: torch.Tensor, config: ConvLSTMConfig, mesh: Mesh,
                    hoist: bool) -> torch.Tensor:
    """The per-cell route on a rank's tile (x (B, T, h, w, C)), with or
    without the hoisted input conv: every cell a ``_TileCell`` given its
    f32 kernel (the combined [w_x; w_h], or the hoisted layer 0's w_h), so
    each tile's weight gradient stays f32 until the all-reduce sums it; each
    kernel cast to the compute dtype once.  The hoist is
    ``_TileHoistedConv`` on the tile's frames."""
    cells = params["cells"]
    f32, dt = torch.float32, config.torch_dtype
    if hoist:
        kernels = ([(cells[0]["w_h"], cells[0]["b"].float())]
                   + combined_cells({"cells": cells[1:]}, f32))
        weights = {"cells": kernels, "w_x0": cells[0]["w_x"], "w_h0": cells[0]["w_h"]}
    else:
        weights = {"cells": combined_cells(params, f32)}
    low = {}

    def cell(xh, c, w, b, xg=None):
        if id(w) not in low:
            low[id(w)] = w.detach().to(dt)
        return _TileCell.apply(join_xh(xh, dt), c, w, b, mesh, low[id(w)], xg)

    return convlstm_apply(params, x, config, precompute_input_conv=hoist, weights=weights,
                          cell_fn=cell, hoist_fn=_hoist_on_tile(mesh, config))


def _tile_forward(bundle: ModelBundle, mesh: Mesh) -> Callable:
    """``forward(params, state, x, rng) -> (tile prediction (B, h, w, 1),
    new state)`` of a training step on this rank's tile x (its dp share
    cut over lat and lon): the ConvLSTM's cells on the tile by its route,
    the UNet and the pix2pix generator through ``bundle.apply`` with the
    mesh."""
    if bundle.family != "LSTM":
        def forward(params, state, x, rng):
            return bundle.apply(params, state, x, training=True, rng=rng, mesh=mesh,
                                tiles=True)
        return forward
    cfg = bundle.config
    hoist = bundle.precompute_input_conv
    cell, grads = _tile_cell(mesh), _tile_grads(mesh)

    def forward(params, state, x, rng):
        if cfg.remat and not hoist:
            return convlstm_apply(params, x, cfg, cell_fn=cell, grads_fn=grads), state
        return _per_cell_tiles(params, x, cfg, mesh, hoist), state
    return forward


def make_spatial_train_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
) -> Callable:
    """The training step with the grid sharded over ``mesh`` (dp, lat,
    lon): ``step(params, state, x_raw, y_raw, rng=None) -> (new_state,
    metrics)``, x_raw (B, [T,] C, h, w) and y_raw (B, h, w) the whole raw
    global batch on every rank (tensors or numpy).  Every rank prepares the
    whole batch, takes its dp share and its tile, runs the model on the
    tile (``_tile_forward``) and sums its part of the loss; one all-reduce
    of gradients, loss and R^2's statistics (``reduce_gradients``), then the
    same Adam update of ``params`` in place on every rank.  ``metrics`` are
    the global batch's ``loss`` and ``r2``, as device scalars; the new
    state (the UNet's running statistics) is the same on every rank.
    ``rng`` draws pix2pix's dropout masks, the same on every rank.  Every
    rank of the mesh calls it.

    Every family of the registry: the ConvLSTM on its route (whole-scan
    BPTT with ``remat``, else the per-cell route, with or without the
    hoisted input conv), the UNet and the pix2pix generator on tiles with
    the gather rule (parallel/halo.py).  The padded grid must split evenly
    over lat and lon.

    On a CUDA mesh each call is one CUDA graph replay (graph.py:
    the halo exchanges, their transposes and the all-reduces captured,
    "thread_local"); ``step.eager`` runs it without one, ``step.body`` is
    the step on device tensors.  On gloo it runs eagerly."""
    padded_shape = tuple(padded_shape or grid_shape)
    _check_tiles(padded_shape, mesh)
    preprocess = make_preprocess_fn(normalizer, padded_shape, static=static)
    forward = _tile_forward(bundle, mesh)
    lat = 2 if bundle.is_sequence else 1
    (tr, tc), (gr, gc) = _crop_window(padded_shape, grid_shape, mesh)

    def train_step(params, state, x, y, rng=None):
        x, y = preprocess(x, y)
        x = _tile(x, mesh, lat, 0).contiguous()
        y = _tile(y, mesh, batch_axis=0)
        count = y.numel()  # the dp share's pixels of the cropped grid
        y = y[:, gr, gc]
        optimizer.zero_grad(set_to_none=True)
        pred, new_state = forward(params, state, x, rng)
        pred = pred[:, tr, tc, 0]
        d = y - pred
        loss = (torch.sum(d * d) + torch.sum(torch.abs(d))) / count
        loss.backward()
        with torch.no_grad():
            loss, stats = reduce_gradients(params, loss, r2_stats(y, pred), mesh)
        optimizer.step()
        return new_state, {"loss": loss, "r2": r2_from_stats(stats)}

    return graph_step(train_step, (optimizer,), prepare=host_batch)


def make_spatial_eval_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = False,
) -> Callable:
    """The eval step with the grid sharded: ``step(params, state, x_raw,
    y_raw) -> (per-sample R^2 of the global batch, pred)``, the whole raw
    batch on every rank; the forward runs on the tile (the ConvLSTM's
    ``convlstm_apply_sharded``, with the hoist if the bundle has it; the
    UNet, normalizing by the running statistics of ``state``, and the
    pix2pix generator through ``bundle.apply`` with the mesh), its tiles
    gathered over lat and lon and cropped, pred this rank's dp share
    (normalized, or in physical units when ``unnormalize``).  On a CUDA
    mesh one CUDA graph replay, as the train step."""
    padded_shape = tuple(padded_shape or grid_shape)
    _check_tiles(padded_shape, mesh)
    preprocess = make_preprocess_fn(normalizer, padded_shape, static=static)

    def eval_step(params, state, x, y):
        x, y = preprocess(x, y)
        if bundle.family == "LSTM":
            tile = convlstm_apply_sharded(params, x, bundle.config, mesh,
                                          precompute_input_conv=bundle.precompute_input_conv)
        else:
            with torch.no_grad():
                tile, _ = bundle.apply(params, state, _tile(x, mesh, 1, 0).contiguous(),
                                       training=False, mesh=mesh, tiles=True)
        pred = crop_to_grid(gather_tiles(tile[..., 0], mesh, lat_axis=1, lon_axis=2,
                                         batch_axis=None), grid_shape)
        scores = gather_axis(per_sample_r2_score(_tile(y, mesh, batch_axis=0), pred), mesh,
                             "dp", 0)
        return scores, normalizer.unnormalize_y(pred) if unnormalize else pred

    return graph_step(eval_step, writes=False, prepare=host_batch)


def _sharded_entry(body, weights, warm, inputs, outputs, mesh: Mesh) -> Callable:
    """A sharded serving entry point ``fn(params, *args)``: ``inputs(params,
    *args)`` makes the chunk's device inputs outside any graph (tiles cut,
    carries moved), ``body(params, weights(params), *inputs)`` is the
    chunk's device work, ``outputs`` shapes what it returns.  On a CUDA
    mesh each call replays the chunk's CUDA graph (``fn.runner``, captured
    once per input signature after a warm-up on ``warm(inputs)``); on the
    CPU the body runs eagerly.  ``fn.eager`` runs the body without a graph,
    ``fn.body`` and ``fn.inputs`` are its parts."""
    runner = Graphed(body, weights=weights, warm=warm)

    def run(graph: bool, params, *args):
        with torch.inference_mode():
            ins = inputs(params, *args)
            return outputs((runner if graph else runner.eager)(params, *ins))

    def fn(params, *args):
        return run(True, params, *args)

    fn.eager = lambda params, *args: run(False, params, *args)
    fn.body, fn.inputs, fn.runner = body, inputs, runner
    return fn


def _rollout_out(out):
    return out[0], nest_state(list(out[1:]))


def make_sharded_rollout_fn(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = True,
    cell_fn: CellFn = fused_cell_forward,
) -> Callable:
    """The state-carrying rollout of ``make_rollout_fn`` with the grid
    sharded over ``mesh``: ``rollout(params, forcings, initial_state=None)
    -> (preds, state)``, forcings raw (B, T, C, h, w) (the whole batch on
    every rank), preds (B, T, h, w) in physical units on every rank, state
    this rank's per-layer tile carry (B / dp, H / lat, W / lon, hidden)
    (``scatter_state`` makes one from a global carry).  Every rank of the
    mesh calls it; it runs on the mesh's device without grad, each call one
    CUDA graph replay on a card (``_sharded_entry``).  ``cell_fn`` is the
    cell run on each extended tile (``fused_cell_forward_plain``: the plain
    version on any device)."""
    _check_tiles(padded_shape, mesh)
    dt = config.torch_dtype
    cast = dt if dt != torch.float32 else None
    static_z = None if static is None else DeviceConst(zscore_static(static))
    cell = _tile_cell(mesh, cell_fn)

    def body(params, weights, forcings, *state):
        st = None if static_z is None else static_z.on(forcings.device)
        xs = _tile(_prep_frame(forcings, normalizer, st, padded_shape, cast), mesh, 2)
        taps, state = _scan_tile(params, weights, xs, nest_state(state), config, cell)
        preds = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3), grid_shape)
        return ((normalizer.unnormalize_y(preds) if unnormalize else preds),
                *flat_state(state))

    def inputs(params, forcings, initial_state=None):
        forcings = _tile(torch.as_tensor(forcings, device=mesh.device), mesh, batch_axis=0)
        return [forcings, *_state_inputs(
            initial_state, mesh.device,
            lambda: zero_tile_state(config, forcings.shape[0], padded_shape, mesh))]

    return _sharded_entry(body, lambda params: serving_weights(params, config), first_step,
                          inputs, _rollout_out, mesh)


def _stacked_state_inputs(state, config, S, B, padded_shape, mesh) -> list:
    """The stacked (S, B, h, w, hidden) tile carry as flat state inputs."""
    return _state_inputs(state, mesh.device, lambda: _stack_states(
        [zero_tile_state(config, B, padded_shape, mesh) for _ in range(S)]))


def make_sharded_multitracer_rollout(
    config: ConvLSTMConfig,
    normalizers: Sequence[Normalizer],
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
) -> Callable:
    """BASELINE config #5: S per-species emulators, each on the sharded
    grid, one after another: ``rollout(stacked_params, forcings,
    state=None) -> (preds, state)`` with forcings (S, B, T, C, h, w) raw,
    preds (S, B, T, h, w) in physical units on every rank and the stacked
    tile carry (S, B / dp, H / lat, W / lon, hidden) (rollout/multitracer.py
    with the grid sharded); one CUDA graph replay per call on a card."""
    _check_tiles(padded_shape, mesh)
    S = len(normalizers)
    cell = _tile_cell(mesh)

    def body(stacked_params, weights, forcings, *state):
        state = nest_state(state)
        preds, new_states = [], []
        for s in range(S):
            params = _species(stacked_params, s)
            x = normalizers[s].normalize_x(forcings[s])
            x = _tile(torch.movedim(pad_geo(x, padded_shape), -3, -1), mesh, 2)
            taps, st = _scan_tile(params, weights[s], x, [(h[s], c[s]) for h, c in state],
                                  config, cell)
            p = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3), grid_shape)
            preds.append(normalizers[s].unnormalize_y(p))
            new_states.append(st)
        return (torch.stack(preds), *flat_state(_stack_states(new_states)))

    def inputs(stacked_params, forcings, state=None):
        forcings = _tile(torch.as_tensor(forcings, device=mesh.device), mesh, batch_axis=1)
        return [forcings, *_stacked_state_inputs(state, config, S, forcings.shape[1],
                                                 padded_shape, mesh)]

    # warm up on one step of the (S, B, T, ...) forcings
    return _sharded_entry(body, _species_weights(config, S),
                          lambda xs: [xs[0][:, :, :1], *xs[1:]], inputs, _rollout_out, mesh)


def make_sharded_multitracer_rollout_shared(
    config: ConvLSTMConfig,
    normalizers: Sequence[Normalizer],
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
) -> Callable:
    """Config #5 with the meteorology shared (what scripts/
    torch_run_decadal_rollout.py serves): ``rollout(stacked_params, met,
    emissions, state=None)`` with met (B, T, C-1, h, w) and emissions
    (S, B, T, h, w) raw.  The meteorology is normalized, cast and padded
    once and its tile feeds every species; each step concatenates it with
    the species' emission tile inside the time loop.  Returns as
    ``make_sharded_multitracer_rollout``; one CUDA graph replay per call on
    a card."""
    _check_tiles(padded_shape, mesh)
    S = len(normalizers)
    dt = config.torch_dtype
    n0 = normalizers[0]
    met_norm = Normalizer(n0.x_mean[:-1], n0.x_std[:-1], n0.y_mean, n0.y_std)
    emis_norms = [Normalizer(n.x_mean[-1:], n.x_std[-1:], n.y_mean, n.y_std)
                  for n in normalizers]
    cell = _tile_cell(mesh)

    def body(stacked_params, weights, met, emissions, *state):
        state = nest_state(state)
        m = met_norm.normalize_x(met).to(dt)
        met_xs = _tile(torch.movedim(pad_geo(m, padded_shape), -3, -1), mesh, 2)
        preds, new_states = [], []
        for s in range(S):
            params = _species(stacked_params, s)
            e = emis_norms[s].normalize_x(emissions[s]).to(dt)
            e = _tile(pad_geo(e, padded_shape)[..., None], mesh, 2)
            taps, st = _scan_tile(params, weights[s], (met_xs, e),
                                  [(h[s], c[s]) for h, c in state], config, cell)
            p = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3), grid_shape)
            preds.append(normalizers[s].unnormalize_y(p))
            new_states.append(st)
        return (torch.stack(preds), *flat_state(_stack_states(new_states)))

    def inputs(stacked_params, met, emissions, state=None):
        met = _tile(torch.as_tensor(met, device=mesh.device), mesh, batch_axis=0)
        emissions = _tile(torch.as_tensor(emissions, device=mesh.device), mesh, batch_axis=1)
        return [met, emissions, *_stacked_state_inputs(state, config, S, met.shape[0],
                                                       padded_shape, mesh)]

    # warm up on one step of met (B, T, ...) and emissions (S, B, T, ...)
    return _sharded_entry(body, _species_weights(config, S),
                          lambda xs: [xs[0][:, :1], xs[1][:, :, :1], *xs[2:]], inputs,
                          _rollout_out, mesh)


def make_sharded_feedback_rollout(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
) -> Callable:
    """The closed loop of config #3 with the grid sharded: the contract of
    ``evalx.evaluate.make_closed_loop_chunk``, ``run_chunk(params, state,
    prev_norm, x_chunk) -> (state, prev_norm, preds)``, x_chunk raw
    (Tc, C-1, h, w), prev_norm (1, h, w) normalized, preds (Tc, h, w) in
    physical units (both global, on every rank), state this rank's tile
    carry (1, H / lat, W / lon, hidden) or None for zeros.  Each step's
    prediction tiles are gathered over lat and lon, cropped, and the next
    step's feedback channel is ``pad_geo`` of that frame, cut to the tile.
    Every dp rank of a mesh runs the same batch-1 loop; one CUDA graph
    replay per call on a card."""
    _check_tiles(padded_shape, mesh)
    dt = config.torch_dtype
    tile_cell = _tile_cell(mesh)

    def body(params, weights, x_chunk, prev_norm, *state):
        xn = normalizer.normalize_x(x_chunk)
        # (Tc, 1, h, w, C-1) tiles in the compute dtype, once per chunk
        xs = _tile(torch.movedim(pad_geo(xn, padded_shape), 1, -1)[:, None].to(dt), mesh, 2)
        st, prev, preds = nest_state(state), prev_norm, []
        for t in range(xs.shape[0]):
            fb = _tile(fb_channel(prev, padded_shape), mesh, 1).to(dt)
            st = cells_step(weights["cells"], torch.cat([xs[t], fb], dim=-1), st, tile_cell)
            tap = head_apply(params, st[-1][0], dt)
            prev = crop_to_grid(gather_tiles(tap[..., 0], mesh, lat_axis=1, lon_axis=2,
                                             batch_axis=None), grid_shape)
            preds.append(prev)
        return (prev, normalizer.unnormalize_y(torch.cat(preds)), *flat_state(st))

    def inputs(params, state, prev_norm, x_chunk):
        return [torch.as_tensor(x_chunk, device=mesh.device),
                torch.as_tensor(prev_norm, device=mesh.device),
                *_state_inputs(state, mesh.device,
                               lambda: zero_tile_state(config, 1, padded_shape, mesh))]

    def outputs(out):
        prev, preds, *st = out
        return nest_state(st), prev, preds

    return _sharded_entry(body, lambda params: serving_weights(params, config),
                          lambda xs: [xs[0][:1], *xs[1:]], inputs, outputs, mesh)
