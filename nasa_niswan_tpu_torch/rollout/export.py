"""Frozen serving artifacts and persisted carries (counterpart of
nasa_niswan_tpu/rollout/export.py).

``export_rollout`` traces the state-carrying rollout, with the trained
weights and the normalization constants baked in, through
``torch.export.export`` and writes it with ``torch.export.save`` to a
``.pt2`` file.  A serving process loads it with ``load_rollout`` and calls
it without the checkpoint or the model code: only the port's kernel library
(the ``niswan::*`` custom ops, registered by importing
``nasa_niswan_tpu_torch.ops.convlstm_cell``) is needed, since an artifact
exported on the card holds B1 as ``niswan::convlstm_cell`` (traced through
its fake implementation).  An artifact runs on the device it was exported
for (asked for another device type, ``load_rollout_info`` raises), and its
forcings signature (batch, chunk_steps, C, h, w) is fixed;
on a CUDA device the loaded program is replayed as a CUDA graph
(rollout/graph.py), as the live rollout is.  The ``.pt2`` file is the
port's own format: it is not interchangeable with the JAX package's
StableHLO artifact.  (AOTInductor is not the route: it cannot compile an op
bound through ctypes.)

The carry files (``save_rollout_state`` / ``load_rollout_state``) are the
JAX package's ``.npz`` layout: the dense (B, Hp, Wp, hidden) f32 ``h<i>``
and ``c<i>`` of each layer, plus the closed loop's ``prev_norm``; a carry
saved by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, cell_weights
from nasa_niswan_tpu_torch.ops import convlstm_cell  # noqa: F401  (registers niswan::*)
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    flat_state,
    make_rollout_fn,
    nest_state,
    zero_state,
)
from nasa_niswan_tpu_torch.rollout.graph import GraphRunner

_INFO = "rollout_info.json"


def rollout_state_spec(config: ConvLSTMConfig, batch: int, padded_shape: Tuple[int, int]):
    """The carry's layout: per layer (h, c) as meta tensors (shape, f32)."""
    H, W = padded_shape
    return [
        (torch.empty((batch, H, W, hc), device="meta"),
         torch.empty((batch, H, W, hc), device="meta"))
        for hc in config.hidden_channels
    ]


def initial_rollout_state(config: ConvLSTMConfig, batch: int,
                          padded_shape: Tuple[int, int], device=None):
    """Zero carry in the dense layout."""
    return zero_state(config, batch, padded_shape, device)


class _Served(torch.nn.Module):
    """``forward(forcings, *flat carry) -> (preds, *flat carry)``: the live
    rollout's body (``make_rollout_fn(...).body``) with the combined cell
    kernels and the head held as buffers.  The normalization constants and
    the static channels, which the body keeps on the device, are lifted
    into the program as constants."""

    def __init__(self, config, normalizer, params, *, grid_shape, padded_shape, static):
        super().__init__()
        self.body = make_rollout_fn(config, normalizer, padded_shape=padded_shape,
                                    grid_shape=grid_shape, static=static).body
        with torch.no_grad():
            cells = cell_weights(params, config)["cells"]
        self.n_layers = len(cells)
        for i, (w, b) in enumerate(cells):
            self.register_buffer(f"w{i}", w.detach().clone())
            self.register_buffer(f"b{i}", b.detach().clone())
        self.register_buffer("head_w", params["head"]["w"].detach().clone())
        self.register_buffer("head_b", params["head"]["b"].detach().clone())

    def forward(self, forcings, *state):
        params = {"cells": [], "head": {"w": self.head_w, "b": self.head_b}}
        weights = {"cells": [(getattr(self, f"w{i}"), getattr(self, f"b{i}"))
                             for i in range(self.n_layers)]}
        return self.body(params, weights, forcings, *state)


def export_rollout(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    params,
    *,
    batch: int,
    chunk_steps: int,
    n_channels: int,
    grid_shape: Tuple[int, int] = (90, 144),
    padded_shape: Tuple[int, int] = (100, 154),
    static: Optional[np.ndarray] = None,
    path: Optional[str] = None,
) -> int:
    """Export ``rollout(forcings, state) -> (preds, state)`` with ``params``
    baked in, on the parameters' device: raw forcings (batch, chunk_steps,
    n_channels, *grid_shape) f32 and a dense carry in, physical-unit
    predictions and the next carry out.  Writes the ``.pt2`` file to
    ``path`` when given and returns its size in bytes (0 without a path)."""
    module = _Served(config, normalizer, params, grid_shape=grid_shape,
                     padded_shape=padded_shape, static=static)
    device = params["head"]["w"].device
    shape = (batch, chunk_steps, n_channels, *grid_shape)
    example = (torch.zeros(shape, device=device),
               *flat_state(initial_rollout_state(config, batch, padded_shape, device)))
    with torch.no_grad():
        # one eager run puts every constant the body keeps on the device
        # there before tracing
        module(*example)
        ep = torch.export.export(module, example, strict=False)
    if path is None:
        return 0
    info = {"forcings": list(shape), "device": str(device)}
    torch.export.save(ep, path, extra_files={_INFO: json.dumps(info)})
    return os.path.getsize(path)


def load_rollout(path: str):
    """Load an exported rollout as ``rollout(forcings, state) -> (preds,
    state)``."""
    fn, _ = load_rollout_info(path)
    return fn


def load_rollout_info(path: str, device=None):
    """Load an artifact and report its fixed forcings signature: returns
    ``(fn, (batch, chunk_steps, n_channels, h, w))``.  ``fn`` runs on the
    device the artifact was exported for (``fn.device``), as a CUDA graph
    replay there (``fn.runner``; its warm-up runs the whole chunk, since
    the signature is fixed).  When ``device`` is given and is of another
    type than that, a ``ValueError`` is raised: the program's weights and
    kernels live on its own device, and serving it elsewhere would run it
    there all the same."""
    extra = {_INFO: ""}
    ep = torch.export.load(path, extra_files=extra)
    info = json.loads(extra[_INFO])
    home = torch.device(info["device"])
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(
            f"artifact {path} was exported for {home}; it cannot serve on "
            f"{torch.device(device)}: export it there"
        )
    program = ep.module()
    runner = GraphRunner(lambda params, weights, *xs: program(*xs), lambda params: None)

    def fn(forcings, state):
        with torch.inference_mode():
            inputs = [torch.as_tensor(forcings, device=home)]
            inputs += [torch.as_tensor(t, device=home, dtype=torch.float32).contiguous()
                       for t in flat_state(state)]
            out = runner(None, inputs) if home.type == "cuda" else program(*inputs)
        return out[0], nest_state(list(out[1:]))

    fn.runner = runner
    fn.device = home
    return fn, tuple(info["forcings"])


def save_rollout_state(path: str, state, *, prev_norm=None) -> None:
    """Persist a rollout carry to ``.npz`` (dense layout, f32): ``h<i>`` and
    ``c<i>`` per layer, and the closed loop's feedback frame ``prev_norm``
    (normalized) when given, so a resumed episode continues bit-exactly."""
    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a)).astype(np.float32)

    arrays = {}
    for li, (h, c) in enumerate(state):
        arrays[f"h{li}"] = host(h)
        arrays[f"c{li}"] = host(c)
    if prev_norm is not None:
        arrays["prev_norm"] = host(prev_norm)
    np.savez_compressed(path, **arrays)


def load_rollout_state(path: str):
    """Load a carry saved by either package's ``save_rollout_state``.
    Returns ``(state, prev_norm)`` as numpy arrays; ``prev_norm`` is None
    for an open-loop carry."""
    with np.load(path) as z:
        n_layers = sum(1 for k in z.files if k.startswith("h"))
        state = [(z[f"h{li}"], z[f"c{li}"]) for li in range(n_layers)]
        prev = z["prev_norm"] if "prev_norm" in z.files else None
    return state, prev
