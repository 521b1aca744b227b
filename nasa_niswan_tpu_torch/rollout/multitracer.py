"""Multi-tracer serving (counterpart of nasa_niswan_tpu/rollout/multitracer.py,
BASELINE config #5).

ModelE needs every tracer at every timestep, and each species has its own
emulator.  The multi-tracer rollouts run S per-species emulators as one
program: on a CUDA device one captured CUDA graph replays all S rollouts
(graph.py), the counterpart of the JAX package's one jitted
program.  As there, they are S plain per-species loops, never grouped
convolutions over stacked filters.  Parameters and carries are stacked on a
leading species axis; the shared-meteorology variant prepares the
meteorology once and concatenates each species' emission channel inside
the step loop (``convlstm_apply``'s tuple input).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.graph import Graphed
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_apply, head_apply
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    flat_state,
    nest_state,
    serving_weights,
    zero_state,
)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_params(params_list: Sequence) -> dict:
    """Stack S parameter trees of one structure on a new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def stack_normalizers(norms: Sequence[Normalizer]) -> Normalizer:
    """Per-species normalization constants stacked: (S, C) / (S,) arrays."""
    return Normalizer(
        x_mean=np.stack([n.x_mean for n in norms]),
        x_std=np.stack([n.x_std for n in norms]),
        y_mean=np.stack([np.float32(n.y_mean) for n in norms]),
        y_std=np.stack([np.float32(n.y_std) for n in norms]),
    )


def _species(stacked_params, s: int):
    return _tree_map(lambda x: x[s], stacked_params)


def _stack_states(states) -> list:
    """Per-species carries -> the stacked (S, ...) carry, layer-major."""
    return [
        (torch.stack([st[li][0] for st in states]), torch.stack([st[li][1] for st in states]))
        for li in range(len(states[0]))
    ]


def _tap(params, grid_shape, dt, normalizer: Normalizer):
    def tap(h_last):
        p = crop_to_grid(head_apply(params, h_last, dt)[..., 0], grid_shape)
        return normalizer.unnormalize_y(p)
    return tap


def _species_weights(config, S: int):
    """The ``weights`` hook of an S-species rollout: each species' serving
    weights, made before the capture."""
    return lambda stacked: [serving_weights(_species(stacked, s), config) for s in range(S)]


def _runner(body, config, S, warm):
    """The S-species runner: a replay on a CUDA device, the body eagerly
    elsewhere."""
    return Graphed(body, weights=_species_weights(config, S), warm=warm)


def _state_inputs(config, state, S, B, padded_shape, device):
    if state is None:
        return flat_state(_stack_states(
            [zero_state(config, B, padded_shape, device) for _ in range(S)]))
    return [torch.as_tensor(t, device=device, dtype=torch.float32).contiguous()
            for t in flat_state(state)]


def make_multitracer_rollout(
    config: ConvLSTMConfig,
    normalizers: Sequence[Normalizer],
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
):
    """Rollout over S species at once: ``rollout(stacked_params, forcings,
    state=None) -> (preds, state)`` with ``forcings`` (S, B, T, C, H, W) raw
    per-species streams, ``preds`` (S, B, T, h, w) in physical units and the
    stacked (S, B, Hp, Wp, hidden) carry.  Runs on the parameters' device."""
    S = len(normalizers)
    dt = config.torch_dtype

    def body(stacked_params, weights, forcings, *state):
        state = nest_state(state)
        preds, new_states = [], []
        for s in range(S):
            params = _species(stacked_params, s)
            x = normalizers[s].normalize_x(forcings[s])
            x = torch.movedim(pad_geo(x, padded_shape), -3, -1)
            _, p, ns = convlstm_apply(
                params, x, config, return_per_step=True,
                initial_state=[(h[s], c[s]) for h, c in state], return_state=True,
                tap_fn=_tap(params, grid_shape, dt, normalizers[s]), weights=weights[s],
            )
            preds.append(p)
            new_states.append(ns)
        return (torch.stack(preds), *flat_state(_stack_states(new_states)))

    # warm up on one step of the (S, B, T, ...) forcings
    runner = _runner(body, config, S, lambda xs: [xs[0][:, :, :1], *xs[1:]])

    def rollout(stacked_params, forcings, state=None):
        device = stacked_params["head"]["w"].device
        forcings = torch.as_tensor(forcings, device=device)
        inputs = [forcings, *_state_inputs(config, state, S, forcings.shape[1],
                                           padded_shape, device)]
        with torch.inference_mode():
            out = runner(stacked_params, *inputs)
        return out[0], nest_state(list(out[1:]))

    rollout.runner = runner
    return rollout


def make_multitracer_rollout_shared(
    config: ConvLSTMConfig,
    normalizers: Sequence[Normalizer],
    *,
    padded_shape: Tuple[int, int] = (100, 154),
    grid_shape: Tuple[int, int] = (90, 144),
):
    """Multi-tracer rollout with the meteorology shared:
    ``rollout(stacked_params, met, emissions, state=None)`` with ``met``
    (B, T, C-1, H, W) and ``emissions`` (S, B, T, H, W), raw.  The
    meteorology is normalized (species 0's statistics: the species differ
    only in their emission and concentration slots), cast and padded once;
    each step concatenates it with the species' emission channel inside the
    step loop.  Returns as ``make_multitracer_rollout``."""
    S = len(normalizers)
    dt = config.torch_dtype
    n0 = normalizers[0]
    met_norm = Normalizer(n0.x_mean[:-1], n0.x_std[:-1], n0.y_mean, n0.y_std)
    emis_norms = [Normalizer(n.x_mean[-1:], n.x_std[-1:], n.y_mean, n.y_std)
                  for n in normalizers]

    def body(stacked_params, weights, met, emissions, *state):
        state = nest_state(state)
        m = met_norm.normalize_x(met).to(dt)
        met_xs = torch.movedim(pad_geo(m, padded_shape), -3, -1)  # (B, T, H, W, C-1)
        preds, new_states = [], []
        for s in range(S):
            params = _species(stacked_params, s)
            e = emis_norms[s].normalize_x(emissions[s]).to(dt)
            e = pad_geo(e, padded_shape)[..., None]  # (B, T, H, W, 1)
            _, p, ns = convlstm_apply(
                params, (met_xs, e), config, return_per_step=True,
                initial_state=[(h[s], c[s]) for h, c in state], return_state=True,
                tap_fn=_tap(params, grid_shape, dt, normalizers[s]), weights=weights[s],
            )
            preds.append(p)
            new_states.append(ns)
        return (torch.stack(preds), *flat_state(_stack_states(new_states)))

    # warm up on one step of met (B, T, ...) and emissions (S, B, T, ...)
    runner = _runner(body, config, S,
                     lambda xs: [xs[0][:, :1], xs[1][:, :, :1], *xs[2:]])

    def rollout(stacked_params, met, emissions, state=None):
        device = stacked_params["head"]["w"].device
        met = torch.as_tensor(met, device=device)
        emissions = torch.as_tensor(emissions, device=device)
        inputs = [met, emissions, *_state_inputs(config, state, S, met.shape[0],
                                                 padded_shape, device)]
        with torch.inference_mode():
            out = runner(stacked_params, *inputs)
        return out[0], nest_state(list(out[1:]))

    rollout.runner = runner
    return rollout
