"""Whole-chunk BPTT for seq2seq scheduled-sampling training, config #3
(counterpart of nasa_niswan_tpu/ops/seq2seq_bptt.py::scan_seq2seq_pallas2).

The seq2seq chunk (rollout/seq2seq.py) feeds each step's prediction, or the
teacher value per a Bernoulli draw, back into the next step's input: the
reference's feedback channel.  With ``remat`` the whole feedback chunk is
one ``torch.autograd.Function``:

* forward: the time loop carrying (per-layer state, feedback map); per step
  the feedback is geophysically padded and appended to the forcings, the
  fused cells advance (kernel B1 on the card), the 1x1 head and the crop
  give the step's prediction, and the scheduled-sampling blend picks the
  next feedback.  The saved tensors are the per-step input carries and the
  predictions; no gates and no cell intermediates are stored.
* backward: one reverse loop through the same per-step cell backward as
  the whole-scan BPTT (``ops/convlstm_bptt.cells_bwd_step``: kernels B2 and
  B3 on the card).  The feedback cotangent chains through the blend, the
  head and the pad adjoints: d(pred_t) collects the external cotangent and
  the next step's feedback cotangent weighted by (1 - draw_t); the frame
  cotangent's feedback channel goes back through ``pad_geo`` to
  d(pred_{t-1}).  The head and pad adjoints are torch autograd of the small
  functions below, as the JAX package takes ``jax.vjp`` of its own; the
  blend's is written out, as there.  The feedback values are rebuilt from
  the stored predictions and teacher values.

The TPU package's ``_pack_state`` (a lane-padding fix for the stacked
carries) has no counterpart.  Eager autograd through the per-step route
with the plain cell is the oracle.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.ops.convlstm_bptt import (
    _raw_params,
    cell_param_grads,
    cells_bwd_step,
    cells_step,
    combined_cells,
    zero_cell_grads,
)


def fb_channel(fb: torch.Tensor, padded_shape) -> torch.Tensor:
    """(B, h, w) normalized feedback map -> (B, H, W, 1) padded f32 channel
    (the caller casts it to the compute dtype)."""
    return pad_geo(fb, padded_shape)[..., None]


def pred_from_h(h_last, head_w, head_b, grid_shape, dt) -> torch.Tensor:
    """1x1 head on the last layer's h -> cropped normalized (B, h, w)
    prediction: a compute-dtype product promoted to f32 by the f32 bias."""
    p = conv2d(h_last.to(dt), head_w.to(dt), head_b).float()
    return crop_to_grid(p[..., 0], grid_shape)


def feedback_step(cells, head_w, head_b, x_t, fb, state, dt, padded_shape,
                  grid_shape, cell_fn):
    """One step of the feedback chunk: the padded feedback map appended to
    the forcings x_t (B, H, W, C-1), the fused cells, the head and the crop.
    Returns (new per-layer (h, c), the (B, h, w) normalized prediction)."""
    frame = torch.cat([x_t.to(dt), fb_channel(fb, padded_shape).to(dt)], dim=-1)
    state = cells_step(cells, frame, state, cell_fn)
    return state, pred_from_h(state[-1][0], head_w, head_b, grid_shape, dt)


class _ScanSeq2Seq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fns, dt, shapes, xs, prev0n, ysn, draws_f, *flat):
        cell_fn, grads_fn = fns
        padded_shape, grid_shape = shapes
        n_layers = (len(flat) - 2) // 5
        raw = _raw_params(flat, n_layers)
        head_w, head_b = flat[3 * n_layers : 3 * n_layers + 2]
        state0 = flat[3 * n_layers + 2 :]
        state = [(state0[2 * i], state0[2 * i + 1]) for i in range(n_layers)]
        cells = combined_cells(raw, dt)
        fb = prev0n
        carries, preds = [], []
        for t in range(xs.shape[0]):
            state, pred = feedback_step(cells, head_w, head_b, xs[t], fb, state, dt,
                                        padded_shape, grid_shape, cell_fn)
            sel = draws_f[t][:, None, None]
            fb = sel * ysn[t] + (1.0 - sel) * pred
            carries.append(state)
            preds.append(pred)
        preds = torch.stack(preds)
        ctx.grads_fn, ctx.dt, ctx.shapes, ctx.n_layers = grads_fn, dt, shapes, n_layers
        ctx.save_for_backward(
            xs, prev0n, ysn, draws_f, preds, *flat,
            *(t for st in carries for hc in st for t in hc),
        )
        return (*(t for hc in carries[-1] for t in hc), preds)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cotangents):
        L, dt = ctx.n_layers, ctx.dt
        padded_shape, grid_shape = ctx.shapes
        saved = ctx.saved_tensors
        xs, prev0n, ysn, draws_f, preds = saved[:5]
        flat = saved[5 : 5 + 5 * L + 2]
        rest = saved[5 + 5 * L + 2 :]
        raw = _raw_params(flat, L)
        head_w, head_b = flat[3 * L : 3 * L + 2]
        state0 = flat[3 * L + 2 :]
        T, cf = xs.shape[0], xs.shape[-1]
        d_final, d_preds = cotangents[:-1], cotangents[-1]

        def carry(t):
            src, base = (state0, 0) if t == 0 else (rest, 2 * L * (t - 1))
            return [(src[base + 2 * i], src[base + 2 * i + 1]) for i in range(L)]

        # the feedback input of every step, rebuilt from the stored
        # predictions and teacher values (fb_0 is the seed)
        sel = draws_f[:-1, :, None, None]
        fb_seq = torch.cat(
            [prev0n[None], sel * ysn[:-1] + (1.0 - sel) * preds[:-1]], dim=0
        )
        cells = combined_cells(raw, dt)
        g_w, g_b = zero_cell_grads(cells)
        g_hw = torch.zeros_like(head_w, dtype=torch.float32)
        g_hb = torch.zeros_like(head_b, dtype=torch.float32)
        d_state = [
            (d_final[2 * i].float(), d_final[2 * i + 1].float()) for i in range(L)
        ]
        d_fb_next = torch.zeros_like(prev0n)  # the last blend's output is dropped
        state_next = carry(T)
        for t in reversed(range(T)):
            state_in = carry(t)
            # blend adjoint: fb_{t+1} = d_t * y_t + (1 - d_t) * pred_t
            d_pred = d_preds[t] + d_fb_next * (1.0 - draws_f[t][:, None, None])
            # head adjoint on the next-step carry's last-layer h
            with torch.enable_grad():
                h_l, hw, hb = (a.detach().requires_grad_(True)
                               for a in (state_next[L - 1][0], head_w, head_b))
                dh_l, dhw, dhb = torch.autograd.grad(
                    pred_from_h(h_l, hw, hb, grid_shape, dt), (h_l, hw, hb), d_pred
                )
            g_hw += dhw
            g_hb += dhb
            d_state[L - 1] = (d_state[L - 1][0] + dh_l, d_state[L - 1][1])
            frame = torch.cat(
                [xs[t], fb_channel(fb_seq[t], padded_shape).to(dt)], dim=-1
            )
            d_state, d_frame = cells_bwd_step(
                cells, ctx.grads_fn, frame, state_in, state_next, d_state,
                g_w, g_b, dt,
            )
            # the feedback channel's cotangent back through pad_geo
            with torch.enable_grad():
                fb = fb_seq[t].detach().requires_grad_(True)
                (d_fb_next,) = torch.autograd.grad(
                    fb_channel(fb, padded_shape), fb, d_frame[..., cf:].contiguous()
                )
            state_next = state_in
        grads = cell_param_grads(raw, g_w, g_b)
        grads += [g_hw.to(head_w.dtype), g_hb.to(head_b.dtype)]
        grads += [d for dhc in d_state for d in dhc]
        d_prev0 = d_fb_next if ctx.needs_input_grad[4] else None
        return (None, None, None, None, d_prev0, None, None, *grads)


def scan_seq2seq(
    params,
    xs: torch.Tensor,
    prev0n: torch.Tensor,
    ysn: torch.Tensor,
    draws_f: torch.Tensor,
    state0: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    dt: torch.dtype,
    padded_shape,
    grid_shape,
    cell_fn: Callable,
    grads_fn: Callable,
):
    """The feedback chunk through the fused cells; returns (final per-layer
    (h, c) f32, preds (T, B, h, w) normalized f32).

    xs: (T, B, H, W, C-1) forcings in the compute dtype, normalized and
    padded; prev0n: (B, h, w) f32 normalized feedback seed; ysn: (T, B, h, w)
    f32 normalized teacher series; draws_f: (T, B) f32 0/1 scheduled-sampling
    draws (1 = teacher-force); state0: per-layer (h, c) f32.  Differentiable
    in the parameters (cells and head), ``prev0n`` and ``state0``."""
    flat = [t for cell in params["cells"] for t in (cell["w_x"], cell["w_h"], cell["b"])]
    flat += [params["head"]["w"], params["head"]["b"]]
    flat += [t for hc in state0 for t in hc]
    out = _ScanSeq2Seq.apply(
        (cell_fn, grads_fn), dt, (tuple(padded_shape), tuple(grid_shape)),
        xs, prev0n, ysn, draws_f, *flat,
    )
    final = [(out[2 * i], out[2 * i + 1]) for i in range(len(state0))]
    return final, out[-1]
