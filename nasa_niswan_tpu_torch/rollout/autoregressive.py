"""State-carrying autoregressive rollout, the serving mode (counterpart of
nasa_niswan_tpu/rollout/autoregressive.py, ConvLSTM part).

Forcings stream in raw, (B, T, C, H, W); every step normalizes and
geo-pads its frame, advances the stacked cells, and taps head + crop +
unnormalize, so predictions come out (B, T, h, w) in physical units.  The
rollout returns its final carry, so a long run is a chain of chunks, each
fed the previous chunk's state.  The carry is a list of per-layer (h, c),
each (B, Hp, Wp, hidden) f32 in the dense layout, the same as the JAX
rollout returns, so a carry crosses between the packages.

Every frame is prepared up front in one batched op; the step loop is a
Python loop whose cell step is the fused CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import Normalizer, zscore_static
from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    convlstm_apply,
    head_apply,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward


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
    forcings are moved there).
    ``cell_fn`` is passed to ``convlstm_apply``.

    ``precompute_input_conv``: True hoists layer 0's input conv out of the
    time loop (one (B*T)-batched conv, then the kernel's xg mode); None
    is off, set from the device time of one serving step on an NVIDIA
    H100 80GB HBM3 at its 700 W limit (C = 62, B = 1, bf16, one 48-step
    chunk, the profiler's kernel sum; scripts/time_hoist.py, two runs of
    each in turns): 0.1662 and 0.1650 ms/step unhoisted, 0.1568 and 0.1805
    hoisted.  Hoisting saves no device time there, so the fused cell reads
    [x, h] in one launch.  On the host clock neither setting wins across
    calls (chip_smoke.py on the same card, three calls: unhoisted 0.6137,
    0.4575 and 0.4120 ms/step, hoisted 0.4511, 0.4245 and 0.6056), so the
    rule is to be re-read once the serving step runs as a CUDA graph.
    """
    static_np = None if static is None else zscore_static(static)
    dt = config.torch_dtype
    cast = dt if dt != torch.float32 else None

    def tap(params, h_last):
        p = head_apply(params, h_last, dt)
        p = crop_to_grid(p[..., 0], grid_shape)
        return normalizer.unnormalize_y(p) if unnormalize else p

    def rollout(params, forcings, initial_state=None):
        with torch.inference_mode():
            forcings = torch.as_tensor(forcings, device=_device(params, device))
            st = None
            if static_np is not None:
                st = torch.as_tensor(static_np, device=forcings.device)
            xs = _prep_frame(forcings, normalizer, st, padded_shape, cast)
            _, preds, final_state = convlstm_apply(
                params,
                xs,
                config,
                return_per_step=True,
                initial_state=initial_state,
                return_state=True,
                tap_fn=lambda h: tap(params, h),
                precompute_input_conv=bool(precompute_input_conv),
                cell_fn=cell_fn,
            )
        return preds, final_state

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
    parameters')."""
    rollout = make_rollout_fn(
        config, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, device=device,
    )
    state = {"carry": None}
    device = _device(params, device)

    def step(frame) -> torch.Tensor:
        frame = torch.as_tensor(frame, device=device)
        preds, state["carry"] = rollout(params, frame[:, None], state["carry"])
        return preds[:, 0]

    return step


def model_days_per_min(
    n_steps: int, elapsed_s: float, *, steps_per_day: int = 48, batch: int = 1
) -> float:
    """The serving throughput metric: emulated model-days per minute."""
    days = batch * n_steps / steps_per_day
    return days / (elapsed_s / 60.0)
