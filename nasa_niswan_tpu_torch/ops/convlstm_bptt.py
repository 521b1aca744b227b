"""Whole-scan BPTT of the stacked ConvLSTM cells (counterpart of
nasa_niswan_tpu/ops/convlstm_bptt.py::scan_cells_pallas2 with its default
``bwd_impl="fused"``).

One ``torch.autograd.Function`` spans every layer and time step:

* forward: the time loop through the fused cell forward (kernel B1 on the
  card), keeping only each step's *input* carry: the saved tensors are
  (params, xs, state0, the per-step carries, final), as ``_scan_fwd`` keeps.
  No gates and no cell intermediates are stored.
* backward: one reverse loop.  Per step and layer (as ``_cells_bwd_step`` does) the
  per-cell backward ``cell_grads`` (kernels B2 then B3 on the card)
  recomputes the gates and returns (dxh, dc_prev, dw, db).  Layer l > 0's
  forward input at step t is layer l-1's carry h at step t+1, so nothing is
  replayed.

It keeps the reference's roundings: xh and w in the compute dtype, dgates
rounded to it before dW and the data-gradient conv, db from the f32 gate
cotangents, dc_prev = dct * f in f32, the layer-below part of dxh added to
that layer's dh in f32, and dx_t cast to xs's dtype.  Weight and bias
gradients accumulate in f32 over the steps.

The TPU package's ``_pack_state`` (a lane-padding fix for the stacked
carries) has no counterpart: the carries stay a list of tensors.  Eager
autograd through the plain cell (``convlstm_apply`` with ``grads_fn=None``)
is the oracle, as ``bwd_impl="xla"`` is in the reference.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

State = List[Tuple[torch.Tensor, torch.Tensor]]


def combined_cells(params, dt: torch.dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer, the combined [w_x; w_h] kernel in the compute dtype and
    the f32 bias, as the fused cell takes them."""
    return [
        (torch.cat([cell["w_x"], cell["w_h"]], dim=2).to(dt).contiguous(),
         cell["b"].float().contiguous())
        for cell in params["cells"]
    ]


def cells_step(cells, x_t, state, cell_fn) -> State:
    """One time step through every layer; returns the new per-layer (h, c).
    Each cell gets its input as the pair (x, h) as they lie:
    ``fused_cell_forward``'s two-part launch stages [x; h] from it without
    a concatenated copy, and a cell that needs one tensor makes it with
    ``join_xh`` in the compute dtype."""
    inp = x_t
    new = []
    for (w, b), (h, c) in zip(cells, state):
        new.append(cell_fn((inp, h), c, w, b))
        inp = new[-1][0]
    return new


def _raw_params(flat, n_layers):
    return {"cells": [dict(zip(("w_x", "w_h", "b"), flat[3 * i : 3 * i + 3]))
                      for i in range(n_layers)]}


class _ScanCells(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fns, dt, xs, *flat):
        cell_fn, grads_fn = fns
        n_layers = len(flat) // 5
        state0 = [
            (flat[3 * n_layers + 2 * i], flat[3 * n_layers + 2 * i + 1])
            for i in range(n_layers)
        ]
        cells = combined_cells(_raw_params(flat, n_layers), dt)
        carries = [state0]
        for t in range(xs.shape[1]):
            carries.append(cells_step(cells, xs[:, t], carries[-1], cell_fn))
        ctx.grads_fn = grads_fn
        ctx.dt = dt
        ctx.n_layers = n_layers
        ctx.save_for_backward(
            xs, *flat, *(t for st in carries[1:] for hc in st for t in hc)
        )
        return tuple(t for hc in carries[-1] for t in hc)

    @staticmethod
    @once_differentiable
    def backward(ctx, *d_final):
        L, dt = ctx.n_layers, ctx.dt
        saved = ctx.saved_tensors
        xs, flat, rest = saved[0], saved[1 : 1 + 5 * L], saved[1 + 5 * L :]
        raw = _raw_params(flat, L)
        T = xs.shape[1]

        def carry(t):
            src, base = (flat, 3 * L) if t == 0 else (rest, 2 * L * (t - 1))
            return [(src[base + 2 * i], src[base + 2 * i + 1]) for i in range(L)]

        cells = combined_cells(raw, dt)
        g_w, g_b = zero_cell_grads(cells)
        d_state = [
            (d_final[2 * i].float(), d_final[2 * i + 1].float()) for i in range(L)
        ]
        need_dx = ctx.needs_input_grad[2]
        dxs = torch.zeros_like(xs) if need_dx else None
        state_next = carry(T)
        for t in reversed(range(T)):
            state_in = carry(t)
            d_state, d_x = cells_bwd_step(
                cells, ctx.grads_fn, xs[:, t], state_in, state_next, d_state,
                g_w, g_b, dt,
            )
            if need_dx:
                dxs[:, t] = d_x.to(xs.dtype)
            state_next = state_in
        grads = cell_param_grads(raw, g_w, g_b)
        grads += [d for dhc in d_state for d in dhc]
        return (None, None, dxs, *grads)


def zero_cell_grads(cells):
    """f32 accumulators for the combined kernels' and the biases' gradients."""
    return (
        [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w, _ in cells],
        [torch.zeros(b.shape, dtype=torch.float32, device=b.device) for _, b in cells],
    )


def cell_param_grads(raw, g_w, g_b) -> list:
    """The accumulated combined-kernel gradients split back into (w_x, w_h,
    b) per layer, in the parameters' dtypes."""
    grads = []
    for cell, gw, gb in zip(raw["cells"], g_w, g_b):
        cin = cell["w_x"].shape[2]
        grads += [gw[:, :, :cin].to(cell["w_x"].dtype),
                  gw[:, :, cin:].to(cell["w_h"].dtype), gb.to(cell["b"].dtype)]
    return grads


def cells_bwd_step(cells, grads_fn, x_t, state_in, state_next, d_state,
                   g_w, g_b, dt):
    """One step's backward through every layer (``_cells_bwd_step``), from
    the top layer down.  Layer l > 0's forward input is layer l-1's h in
    ``state_next``, so nothing is replayed; the per-cell backward
    ``grads_fn`` recomputes the gates.  Adds the weight and bias gradients
    into ``g_w`` / ``g_b`` (f32) and returns (the per-layer (dh, dc) of
    ``state_in``, the f32 cotangent of ``x_t``)."""
    d_state = list(d_state)
    new_d: list = [None] * len(cells)
    d_x = None
    for li in reversed(range(len(cells))):
        inp = x_t if li == 0 else state_next[li - 1][0]
        (h_in, c_in), (dh, dc) = state_in[li], d_state[li]
        w, b = cells[li]
        xh = torch.cat([inp.to(dt), h_in.to(dt)], dim=-1)
        dxh, dc_prev, dw, db = grads_fn(
            xh, c_in, dh.contiguous(), dc.contiguous(), w, b
        )
        g_w[li] += dw
        g_b[li] += db
        cin = inp.shape[-1]
        if li > 0:
            ph, pc = d_state[li - 1]
            d_state[li - 1] = (ph + dxh[..., :cin], pc)
        else:
            d_x = dxh[..., :cin]
        new_d[li] = (dxh[..., cin:], dc_prev)
    return new_d, d_x


def scan_cells(
    params,
    xs: torch.Tensor,
    state0: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    dt: torch.dtype,
    cell_fn: Callable,
    grads_fn: Callable,
) -> State:
    """Run the cells over ``xs`` (B, T, H, W, Cin) in the compute dtype
    ``dt`` from the per-layer carry ``state0``; returns the final per-layer
    (h, c), f32.  Differentiable in the cell parameters, ``xs`` and
    ``state0``: the backward is the whole-scan BPTT through ``grads_fn``
    (``ops/convgrad.cell_grads``, or ``cell_grads_plain``)."""
    flat = [t for cell in params["cells"] for t in (cell["w_x"], cell["w_h"], cell["b"])]
    flat += [t for hc in state0 for t in hc]
    out = _ScanCells.apply((cell_fn, grads_fn), dt, xs, *flat)
    return [(out[2 * i], out[2 * i + 1]) for i in range(len(state0))]
