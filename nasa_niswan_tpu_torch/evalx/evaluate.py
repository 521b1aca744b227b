"""Closed-loop evaluation of a seq2seq (config #3) snapshot (counterpart of
``make_closed_loop_chunk``, ``zero_closed_loop_state`` and
``predict_test_closed_loop`` in nasa_niswan_tpu/evalx/evaluate.py).

The feedback channel carries the model's own previous prediction, step
after step, with the (h, c) carry and the feedback frame handed from chunk
to chunk, so a whole test period is one continuous episode.  The forcings
of a chunk are normalized, padded and cast once; per step only the
one-channel feedback frame is rebuilt.  Each cell step is the fused kernel
B1 on the card, under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import pad_geo
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.convlstm import CellFn, ConvLSTMConfig
from nasa_niswan_tpu_torch.ops.convlstm_bptt import combined_cells
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import feedback_step


def make_closed_loop_chunk(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    cell_fn: CellFn = fused_cell_forward,
):
    """Returns ``run_chunk(params, state, prev_norm, x_chunk) -> (state,
    prev_norm, preds)``: x_chunk raw (Tc, C-1, h, w), prev_norm (1, h, w)
    normalized, state the per-layer (h, c) carry (1, H, W, hidden) f32,
    preds (Tc, h, w) in physical units.  Runs on x_chunk's device."""
    dt = config.torch_dtype

    def run_chunk(params, state, prev_norm, x_chunk):
        with torch.inference_mode():
            x_chunk = torch.as_tensor(x_chunk)
            dev = x_chunk.device
            xn = normalizer.normalize_x(x_chunk)
            # (Tc, 1, H, W, C-1) in the compute dtype, once per chunk
            xs = torch.movedim(pad_geo(xn, padded_shape), 1, -1)[:, None].to(dt)
            st = [(torch.as_tensor(h, device=dev), torch.as_tensor(c, device=dev))
                  for h, c in state]
            prev = torch.as_tensor(prev_norm, device=dev)
            cells = combined_cells(params, dt)
            preds = []
            head_w, head_b = params["head"]["w"], params["head"]["b"]
            for t in range(xs.shape[0]):
                st, prev = feedback_step(cells, head_w, head_b, xs[t], prev, st, dt,
                                         padded_shape, grid_shape, cell_fn)
                preds.append(prev)
            return st, prev, normalizer.unnormalize_y(torch.cat(preds))

    return run_chunk


def zero_closed_loop_state(config: ConvLSTMConfig, padded_shape, device=None):
    """Zero (h, c) carry for the closed-loop chunk."""
    H, W = padded_shape
    return [
        (torch.zeros((1, H, W, hc), device=device),
         torch.zeros((1, H, W, hc), device=device))
        for hc in config.hidden_channels
    ]


def _run_chunked_episode(run_chunk, carry, frames, chunk_steps: int):
    """Drive a fixed-size-chunk closed-loop episode over ``frames`` (T
    leading): the tail chunk is repeat-padded to the chunk length, the carry
    threads through every chunk (one episode, no resets), and the padding
    is trimmed from the predictions.  ``run_chunk(*carry, x_chunk) ->
    (*carry, preds)``.  Returns the numpy predictions."""
    T = frames.shape[0]
    chunk_steps = min(chunk_steps, T)
    out = []
    for s in range(0, T, chunk_steps):
        x_chunk = frames[s : s + chunk_steps]
        n_valid = x_chunk.shape[0]
        if n_valid < chunk_steps:
            x_chunk = torch.cat(
                [x_chunk, x_chunk[-1:].expand(chunk_steps - n_valid, *x_chunk.shape[1:])]
            )
        *carry, p = run_chunk(*carry, x_chunk)
        out.append(p[:n_valid].cpu().numpy())
    return np.concatenate(out)


def predict_test_closed_loop(
    config: ConvLSTMConfig, params, dataset, *, padded_shape, chunk_steps: int = 480,
) -> Dict[str, np.ndarray]:
    """Closed-loop feedback evaluation over a ``Seq2SeqDataset``'s whole
    split, the deployment condition of a ``--mode seq2seq`` snapshot: each
    step's feedback is the model's own previous prediction (the ground truth
    seeds step 0 only), the carry crosses chunk boundaries.  Returns
    physical-unit GTs / PDs shaped (T, h, w); runs on the parameters'
    device."""
    frames, prev0, targets = dataset.continuous_stream()
    norm = dataset.normalizer
    device = params["head"]["w"].device
    run_chunk = make_closed_loop_chunk(
        config, norm, padded_shape=padded_shape, grid_shape=tuple(targets.shape[-2:])
    )
    state = zero_closed_loop_state(config, padded_shape, device)
    prev_norm = torch.as_tensor(
        np.asarray(norm.normalize_y(prev0), np.float32)[None], device=device
    )
    preds = _run_chunked_episode(
        lambda st, prev, x: run_chunk(params, st, prev, x),
        [state, prev_norm], torch.as_tensor(frames, device=device), chunk_steps,
    )
    return {"GTs": targets, "PDs": preds}
