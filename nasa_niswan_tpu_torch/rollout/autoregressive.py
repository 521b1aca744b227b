"""State-carrying autoregressive rollout, the serving mode (counterpart of
nasa_niswan_tpu/rollout/autoregressive.py), and the closed-loop rollout of
a feedback model (``make_feedback_rollout_fn``, UNet-6ch).

Forcings stream in raw, (B, T, C, H, W); every step normalizes and
geo-pads its frame, advances the stacked cells, and taps head + crop +
unnormalize, so predictions come out (B, T, h, w) in physical units.  The
rollout returns its final carry, so a long run is a chain of chunks, each
fed the previous chunk's state.  The carry is a list of per-layer (h, c),
each (B, Hp, Wp, hidden) f32 in the dense layout, the same as the JAX
rollout returns, so a carry crosses between the packages.

Every frame is prepared up front in one batched op; the step loop is a
Python loop whose cell step is the fused CUDA kernel on the card.  On a
CUDA device the chunk (preparation, step loop, head, crop, unnormalize) is
captured once per input signature and replayed as one CUDA graph
(graph.py), as the JAX package jit-compiles the whole scan; the eager
loop runs on the CPU and is what the graph captures.  Under a
profiler a chunk is the span ``niswan.serve.chunk``, a streaming step
``niswan.serve.step`` holding its frame's upload, ``niswan.serve.upload``
(utils/profiling.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

import nasa_niswan_tpu_torch.graph as cuda_graph
from nasa_niswan_tpu_torch.bridge import tree_leaves
from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import DeviceConst, Normalizer, zscore_static
from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    _state_tensor,
    cell_weights,
    convlstm_apply,
    head_apply,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward, packed_weights
from nasa_niswan_tpu_torch.utils.profiling import span


def _prep_frame(x, normalizer, static, padded_shape, cast_dtype=None):
    """Raw forcing frames (..., C, H, W) -> padded NHWC.

    The JAX package's cast order: normalize in f32, cast to the compute
    dtype, concat the static channels in f32 and cast again, ``pad_geo``,
    then move channels last.
    """
    x = normalizer.normalize_x(x)
    if cast_dtype is not None:
        x = x.to(cast_dtype)
    if static is not None:
        st = static.expand(*x.shape[:-3], *static.shape)
        x = torch.cat([x.float(), st], dim=-3).to(
            cast_dtype if cast_dtype is not None else torch.float32
        )
    if padded_shape is not None:
        x = pad_geo(x, padded_shape)
    return torch.movedim(x, -3, -1)


def _device(params, device) -> torch.device:
    """``device``, or where the parameters live when it is None."""
    return torch.device(device) if device is not None else params["head"]["w"].device


def serving_weights(params, config: ConvLSTMConfig, hoist: bool = False):
    """``cell_weights`` with each kernel's packed image made on the card
    (``packed_weights``): what a captured serving loop reads, made before
    the capture.  The packed images are kept beside the kernels, so they
    live as long as the graph that reads them."""
    weights = cell_weights(params, config, hoist)
    kernels = [w for w, _ in weights["cells"]] + [weights.get("w_h0")]
    weights["packed"] = [packed_weights(w) for w in kernels
                         if w is not None and w.is_cuda]
    return weights


def first_step(inputs):
    """A rollout's inputs cut to the first step of the forcings (B, T, ...):
    what a chunk's graph warms up on."""
    return [inputs[0][:, :1], *inputs[1:]]


def zero_state(config: ConvLSTMConfig, batch: int, padded_shape, device):
    """Zero per-layer (h, c) carry, (batch, Hp, Wp, hidden) f32."""
    H, W = padded_shape
    return [
        (torch.zeros((batch, H, W, hc), device=device),
         torch.zeros((batch, H, W, hc), device=device))
        for hc in config.hidden_channels
    ]


def flat_state(state) -> list:
    return [t for hc in state for t in hc]


def nest_state(flat) -> list:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def make_rollout_fn(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = True,
    precompute_input_conv: Optional[bool] = None,
    device=None,
    cell_fn: CellFn = fused_cell_forward,
) -> Callable:
    """State-carrying rollout for the ConvLSTM emulator.

    Returns ``rollout(params, forcings, initial_state=None) -> (preds,
    final_state)``: ``forcings`` raw (B, T, C, H, W) (tensor or numpy),
    ``preds`` (B, T, h, w) f32 (physical units when ``unnormalize``), and
    ``final_state`` the carry to hand to the next chunk.  Runs under
    ``torch.inference_mode()`` on ``device`` (default: the parameters'; the
    forcings are moved there).  On a CUDA device each call replays the
    chunk's CUDA graph for its (B, T, C, dtype) (``rollout.runner``, a
    ``graph.Graphed``); ``rollout.eager`` runs the same body without a graph.
    ``cell_fn`` is passed to ``convlstm_apply``.

    ``precompute_input_conv``: True hoists layer 0's input conv out of the
    time loop (one (B*T)-batched conv, then the kernel's xg mode); None
    is off, set from serving on an NVIDIA H100 80GB HBM3 at its 700 W
    limit (C = 62, B = 1, bf16, four chained 48-step requests, each a graph
    replay; scripts/time_hoist.py, two runs of each in turns): device time
    (the profiler's kernel sum) 0.1647 and 0.1662 ms/step unhoisted, 0.1812
    and 0.1823 hoisted; host clock 0.1734 and 0.1734 unhoisted, 0.1882 and
    0.1888 hoisted.  Hoisting costs time on both clocks there, so the fused
    cell reads [x, h] in one launch.
    """
    dt = config.torch_dtype
    cast = dt if dt != torch.float32 else None
    hoist = bool(precompute_input_conv)
    static_z = None if static is None else DeviceConst(zscore_static(static))

    def _static(dev):
        return None if static_z is None else static_z.on(dev)

    def body(params, weights, forcings, *state):
        def tap(h_last):
            p = head_apply(params, h_last, dt)
            p = crop_to_grid(p[..., 0], grid_shape)
            return normalizer.unnormalize_y(p) if unnormalize else p

        xs = _prep_frame(forcings, normalizer, _static(forcings.device),
                         padded_shape, cast)
        _, preds, final_state = convlstm_apply(
            params, xs, config, return_per_step=True,
            initial_state=nest_state(state), return_state=True, tap_fn=tap,
            precompute_input_conv=hoist, cell_fn=cell_fn, weights=weights,
        )
        return (preds, *flat_state(final_state))

    def _inputs(params, forcings, initial_state):
        dev = _device(params, device)
        forcings = torch.as_tensor(forcings, device=dev)
        if initial_state is None:
            state = zero_state(config, forcings.shape[0], padded_shape, dev)
        else:
            state = [(_state_tensor(h, dev), _state_tensor(c, dev))
                     for h, c in initial_state]
        return [forcings, *flat_state(state)]

    runner = cuda_graph.Graphed(
        body, weights=lambda params: serving_weights(params, config, hoist), warm=first_step)

    def run(params, forcings, initial_state, graph: bool):
        with span("niswan.serve.chunk"), torch.inference_mode():
            inputs = _inputs(params, forcings, initial_state)
            out = (runner if graph else runner.eager)(params, *inputs)
        return out[0], nest_state(out[1:])

    def rollout(params, forcings, initial_state=None):
        return run(params, forcings, initial_state, graph=True)

    rollout.runner = runner
    rollout.eager = lambda params, forcings, initial_state=None: run(
        params, forcings, initial_state, graph=False)
    rollout.body = body
    return rollout


def make_feedback_rollout_fn(
    apply_fn: Callable,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int] = (256, 256),
    grid_shape: Tuple[int, int] = (90, 144),
) -> Callable:
    """Closed-loop rollout of a feedback model (UNet-6ch): channel 5 of each
    step's input is the model's own previous prediction, in raw units.

    ``apply_fn(params, x_nhwc) -> (B, H, W, 1)``; ``rollout(params,
    forcings) -> preds``: forcings raw (B, T, 6, H, W) whose channel 5 holds
    the ground-truth previous concentration, read at t = 0 only; preds
    (B, T, h, w) in physical units.  Runs eagerly under
    ``torch.inference_mode`` on the parameters' device (the forcings' for a
    tree without tensors)."""

    def rollout(params, forcings):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.as_tensor(forcings).device
        with torch.inference_mode():
            forcings = torch.as_tensor(forcings, device=dev)
            preds, prev = [], None
            for t in range(forcings.shape[1]):
                x_t = forcings[:, t]
                if prev is not None:
                    x_t = x_t.clone()
                    x_t[:, 5] = prev
                x = _prep_frame(x_t, normalizer, None, padded_shape)
                pred = crop_to_grid(apply_fn(params, x)[..., 0], grid_shape)
                prev = normalizer.unnormalize_y(pred)
                preds.append(prev)
            return torch.stack(preds, dim=1)

    return rollout


def make_streaming_rollout(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    params,
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    device=None,
):
    """Stateful wrapper for in-line serving inside a host model: call
    ``step(forcing_frame)`` with one raw (B, C, H, W) frame per model
    timestep; it returns that step's (B, h, w) prediction and keeps the
    carry on the device between calls (``device``, default the
    parameters').  On a CUDA device one step is one CUDA graph replay, and
    the carry stays in the graph's own input buffers: the captured step
    writes its new carry over them (``step.carry()`` reads it)."""
    rollout = make_rollout_fn(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, device=device,
    )
    device = _device(params, device)
    carry = {"state": None}

    def step_body(params, weights, frame, *state):
        preds, *new = rollout.body(params, weights, frame, *state)
        for old, nw in zip(state, new):
            old.copy_(nw)
        return (preds,)

    runner = cuda_graph.Graphed(step_body, weights=lambda p: serving_weights(p, config))

    def step(frame) -> torch.Tensor:
        with span("niswan.serve.step"):
            with span("niswan.serve.upload"):
                frame = torch.as_tensor(frame, device=device)[:, None]
            if not cuda_graph.on_card(device):
                preds, carry["state"] = rollout(params, frame, carry["state"])
                return preds[:, 0]
            with torch.inference_mode():
                state = carry["state"]
                if state is None:
                    state = zero_state(config, frame.shape[0], padded_shape, device)
                (preds,) = runner(params, frame, *flat_state(state))
                carry["state"] = nest_state(runner.last_inputs[1:])
            return preds[:, 0]

    step.runner = runner
    step.carry = lambda: carry["state"]
    return step


def model_days_per_min(
    n_steps: int, elapsed_s: float, *, steps_per_day: int = 48, batch: int = 1
) -> float:
    """The serving throughput metric: emulated model-days per minute."""
    days = batch * n_steps / steps_per_day
    return days / (elapsed_s / 60.0)
