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

The chunks run eagerly (no CUDA graph): NCCL's point-to-point messages in a
captured graph are left for later work.  The GSPMD training step
(``make_spatial_train_step``), which needs a halo exchange with a backward,
is not ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import DeviceConst, Normalizer, zscore_static
from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    cell_weights,
    convlstm_apply,
    head_apply,
)
from nasa_niswan_tpu_torch.ops.convlstm_bptt import cells_step
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import fb_channel
from nasa_niswan_tpu_torch.parallel.halo import halo_exchange_zero
from nasa_niswan_tpu_torch.parallel.mesh import Mesh, gather_tiles, local_tile
from nasa_niswan_tpu_torch.rollout.autoregressive import _prep_frame
from nasa_niswan_tpu_torch.rollout.multitracer import _species, _stack_states


def cell_on_tile(xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 mesh: Mesh, cell_fn: CellFn = fused_cell_forward):
    """One fused cell step on a rank's tile: xh (B, h, w, Cin) = [x; h] in
    the compute dtype, c (B, h, w, hid) f32; returns the tile's (h', c').
    ``cell_fn`` is the cell run on the extended tile (a test passes the
    plain version)."""
    p = w.shape[0] // 2
    if p == 0:
        return cell_fn(xh, c, w, b)
    hl, wl = xh.shape[1:3]
    h2, c2 = cell_fn(halo_exchange_zero(xh, p, mesh), F.pad(c, (0, 0, p, p, p, p)), w, b)
    return (h2[:, p:p + hl, p:p + wl].contiguous(),
            c2[:, p:p + hl, p:p + wl].contiguous())


def _tile_cell(mesh: Mesh) -> CellFn:
    def cell(xh, c, w, b):
        return cell_on_tile(xh, c, w, b, mesh)
    return cell


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


def _tile_state(state, config, batch, padded_shape, mesh):
    if state is None:
        return zero_tile_state(config, batch, padded_shape, mesh)
    return [(torch.as_tensor(h, device=mesh.device).float().contiguous(),
             torch.as_tensor(c, device=mesh.device).float().contiguous()) for h, c in state]


def _scan_tile(params, weights, x, state, config: ConvLSTMConfig, mesh: Mesh):
    """The stacked cells over a chunk of tiles (x (B, T, h, w, C), or a
    tuple of parts concatenated per step): (per-step head taps (B, T, h, w)
    of the tile, final carry)."""
    dt = config.torch_dtype
    _, taps, state = convlstm_apply(
        params, x, config, return_per_step=True, initial_state=state,
        return_state=True, tap_fn=lambda h: head_apply(params, h, dt)[..., 0],
        cell_fn=_tile_cell(mesh), weights=weights,
    )
    return taps, state


def _check_tiles(padded_shape, mesh: Mesh) -> None:
    H, W = padded_shape
    if H % mesh.lat or W % mesh.lon:
        raise ValueError(f"the padded grid {H}x{W} does not tile evenly over "
                         f"(lat, lon) = ({mesh.lat}, {mesh.lon})")


def convlstm_apply_sharded(params, x: torch.Tensor, config: ConvLSTMConfig,
                           mesh: Mesh) -> torch.Tensor:
    """Sharded ConvLSTM forward: x (B, T, H, W, C) on the padded domain,
    the whole tensor on every rank; returns this rank's tile of the
    (B, H, W, 1) prediction (batch over dp, grid over lat and lon), equal
    to ``convlstm_apply``'s there.  Without grad."""
    _check_tiles(x.shape[2:4], mesh)
    with torch.inference_mode():
        x_t = _tile(torch.as_tensor(x, device=mesh.device), mesh, 2, 0)
        state = zero_tile_state(config, x_t.shape[0], x.shape[2:4], mesh)
        _, state = _scan_tile(params, cell_weights(params, config), x_t, state, config,
                              mesh)
        return head_apply(params, state[-1][0], config.torch_dtype)


def make_sharded_rollout_fn(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = True,
) -> Callable:
    """The state-carrying rollout of ``make_rollout_fn`` with the grid
    sharded over ``mesh``: ``rollout(params, forcings, initial_state=None)
    -> (preds, state)``, forcings raw (B, T, C, h, w) (the whole batch on
    every rank), preds (B, T, h, w) in physical units on every rank, state
    this rank's per-layer tile carry (B / dp, H / lat, W / lon, hidden)
    (``scatter_state`` makes one from a global carry).  Every rank of the
    mesh calls it; it runs on the mesh's device without grad."""
    _check_tiles(padded_shape, mesh)
    dt = config.torch_dtype
    cast = dt if dt != torch.float32 else None
    static_z = None if static is None else DeviceConst(zscore_static(static))

    def rollout(params, forcings, initial_state=None):
        with torch.inference_mode():
            forcings = _tile(torch.as_tensor(forcings, device=mesh.device), mesh,
                             batch_axis=0)
            st = None if static_z is None else static_z.on(mesh.device)
            xs = _tile(_prep_frame(forcings, normalizer, st, padded_shape, cast), mesh, 2)
            state = _tile_state(initial_state, config, xs.shape[0], padded_shape, mesh)
            taps, state = _scan_tile(params, cell_weights(params, config), xs, state,
                                     config, mesh)
            preds = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3),
                                 grid_shape)
            return (normalizer.unnormalize_y(preds) if unnormalize else preds), state

    return rollout


def _stacked_tile_state(config, state, S, B, padded_shape, mesh):
    if state is None:
        return [zero_tile_state(config, B, padded_shape, mesh) for _ in range(S)]
    return [[(torch.as_tensor(h[s], device=mesh.device).float().contiguous(),
              torch.as_tensor(c[s], device=mesh.device).float().contiguous())
             for h, c in state] for s in range(S)]


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
    with the grid sharded)."""
    _check_tiles(padded_shape, mesh)
    S = len(normalizers)

    def rollout(stacked_params, forcings, state=None):
        with torch.inference_mode():
            forcings = _tile(torch.as_tensor(forcings, device=mesh.device), mesh,
                             batch_axis=1)
            states = _stacked_tile_state(config, state, S, forcings.shape[1], padded_shape,
                                         mesh)
            preds, new_states = [], []
            for s in range(S):
                params = _species(stacked_params, s)
                x = normalizers[s].normalize_x(forcings[s])
                x = _tile(torch.movedim(pad_geo(x, padded_shape), -3, -1), mesh, 2)
                taps, st = _scan_tile(params, cell_weights(params, config), x, states[s],
                                      config, mesh)
                p = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3),
                                 grid_shape)
                preds.append(normalizers[s].unnormalize_y(p))
                new_states.append(st)
            return torch.stack(preds), _stack_states(new_states)

    return rollout


def make_sharded_multitracer_rollout_shared(
    config: ConvLSTMConfig,
    normalizers: Sequence[Normalizer],
    mesh: Mesh,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
) -> Callable:
    """Config #5 with the meteorology shared (what scripts/
    run_decadal_rollout.py serves): ``rollout(stacked_params, met,
    emissions, state=None)`` with met (B, T, C-1, h, w) and emissions
    (S, B, T, h, w) raw.  The meteorology is normalized, cast and padded
    once and its tile feeds every species; each step concatenates it with
    the species' emission tile inside the time loop.  Returns as
    ``make_sharded_multitracer_rollout``."""
    _check_tiles(padded_shape, mesh)
    S = len(normalizers)
    dt = config.torch_dtype
    n0 = normalizers[0]
    met_norm = Normalizer(n0.x_mean[:-1], n0.x_std[:-1], n0.y_mean, n0.y_std)
    emis_norms = [Normalizer(n.x_mean[-1:], n.x_std[-1:], n.y_mean, n.y_std)
                  for n in normalizers]

    def rollout(stacked_params, met, emissions, state=None):
        with torch.inference_mode():
            met = _tile(torch.as_tensor(met, device=mesh.device), mesh, batch_axis=0)
            emissions = _tile(torch.as_tensor(emissions, device=mesh.device), mesh,
                              batch_axis=1)
            m = met_norm.normalize_x(met).to(dt)
            met_xs = _tile(torch.movedim(pad_geo(m, padded_shape), -3, -1), mesh, 2)
            states = _stacked_tile_state(config, state, S, met.shape[0], padded_shape, mesh)
            preds, new_states = [], []
            for s in range(S):
                params = _species(stacked_params, s)
                e = emis_norms[s].normalize_x(emissions[s]).to(dt)
                e = _tile(pad_geo(e, padded_shape)[..., None], mesh, 2)
                taps, st = _scan_tile(params, cell_weights(params, config), (met_xs, e),
                                      states[s], config, mesh)
                p = crop_to_grid(gather_tiles(taps, mesh, lat_axis=2, lon_axis=3),
                                 grid_shape)
                preds.append(normalizers[s].unnormalize_y(p))
                new_states.append(st)
            return torch.stack(preds), _stack_states(new_states)

    return rollout


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
    Every dp rank of a mesh runs the same batch-1 loop."""
    _check_tiles(padded_shape, mesh)
    dt = config.torch_dtype
    tile_cell = _tile_cell(mesh)

    def run_chunk(params, state, prev_norm, x_chunk):
        with torch.inference_mode():
            x_chunk = torch.as_tensor(x_chunk, device=mesh.device)
            prev = torch.as_tensor(prev_norm, device=mesh.device)
            xn = normalizer.normalize_x(x_chunk)
            # (Tc, 1, h, w, C-1) tiles in the compute dtype, once per chunk
            xs = _tile(torch.movedim(pad_geo(xn, padded_shape), 1, -1)[:, None].to(dt),
                       mesh, 2)
            st = _tile_state(state, config, 1, padded_shape, mesh)
            cells = cell_weights(params, config)["cells"]
            preds = []
            for t in range(xs.shape[0]):
                fb = _tile(fb_channel(prev, padded_shape), mesh, 1).to(dt)
                st = cells_step(cells, torch.cat([xs[t], fb], dim=-1), st, dt, tile_cell)
                tap = head_apply(params, st[-1][0], dt)
                prev = crop_to_grid(gather_tiles(tap[..., 0], mesh, lat_axis=1, lon_axis=2,
                                                 batch_axis=None), grid_shape)
                preds.append(prev)
            return st, prev, normalizer.unnormalize_y(torch.cat(preds))

    return run_chunk
