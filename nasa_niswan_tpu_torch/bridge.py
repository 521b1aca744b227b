"""Weight bridge between the JAX package's parameter tree and the port.

Both packages hold the ConvLSTM as the same tree,
``{"cells": [{"w_x", "w_h", "b"}, ...], "head": {"w", "b"}}``, with HWIO
kernels, so the bridge converts leaves and checks shapes; nothing is
transposed and the round trip is bit-exact.

``load_jax_checkpoint`` reads the ``checkpoint.npz`` that the JAX
package's ``train/checkpoint.save_checkpoint`` writes.  Its parameter
leaves ``p0, p1, ...`` are in ``jax.tree_util`` flatten order, which sorts
dict keys: ``cells[i].b, cells[i].w_h, cells[i].w_x`` for each layer, then
``head.b, head.w``.  So a JAX-trained snapshot serves in the port.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, Params

CKPT_FILE = "checkpoint.npz"


def _expected_shapes(config: ConvLSTMConfig) -> Tuple[List[Dict[str, tuple]], Dict[str, tuple]]:
    cells = []
    in_ch = config.in_channels
    for hid, k in zip(config.hidden_channels, config.kernel_sizes):
        cells.append(
            {"w_x": (k, k, in_ch, 4 * hid), "w_h": (k, k, hid, 4 * hid),
             "b": (4 * hid,)}
        )
        in_ch = hid
    head = {"w": (1, 1, in_ch, config.out_channels), "b": (config.out_channels,)}
    return cells, head


def params_from_jax(tree: Any, *, device=None) -> Params:
    """JAX parameter tree (numpy or jax arrays) -> the port's tree of torch
    tensors (copies, same dtype and layout)."""
    def conv(a):
        return torch.tensor(np.asarray(a), device=device)

    return {
        "cells": [
            {name: conv(cell[name]) for name in ("w_x", "w_h", "b")}
            for cell in tree["cells"]
        ],
        "head": {name: conv(tree["head"][name]) for name in ("w", "b")},
    }


def params_to_jax(params: Params) -> Dict[str, Any]:
    """The port's tree -> the JAX package's tree of numpy arrays."""
    def conv(t):
        return t.detach().cpu().numpy().copy()

    return {
        "cells": [
            {name: conv(cell[name]) for name in ("w_x", "w_h", "b")}
            for cell in params["cells"]
        ],
        "head": {name: conv(params["head"][name]) for name in ("w", "b")},
    }


def load_jax_checkpoint(path: str, config: ConvLSTMConfig, *, device=None) -> Params:
    """Read the ConvLSTM parameters of a JAX ``checkpoint.npz`` (``path`` is
    the file or its epoch directory); raises if the leaves do not match
    ``config``."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_FILE)
    cell_shapes, head_shapes = _expected_shapes(config)
    n_leaves = 3 * len(cell_shapes) + 2
    with np.load(path) as data:
        leaves = []
        for i in range(n_leaves):
            if f"p{i}" not in data:
                raise ValueError(
                    f"{path}: no parameter leaf p{i}; a {config.num_layers}-layer "
                    f"ConvLSTM has {n_leaves}"
                )
            leaves.append(np.asarray(data[f"p{i}"]))
        if f"p{n_leaves}" in data:
            raise ValueError(
                f"{path} holds more than {n_leaves} parameter leaves: not a "
                f"{config.num_layers}-layer ConvLSTM"
            )
    # flatten order sorts keys: b, w_h, w_x per cell, then b, w of the head
    it = iter(leaves)
    tree: Dict[str, Any] = {
        "cells": [
            {name: next(it) for name in ("b", "w_h", "w_x")} for _ in cell_shapes
        ],
    }
    tree["head"] = {name: next(it) for name in ("b", "w")}
    for i, (cell, shapes) in enumerate(zip(tree["cells"], cell_shapes)):
        for name, shape in shapes.items():
            if cell[name].shape != shape:
                raise ValueError(
                    f"cells[{i}].{name}: shape {cell[name].shape} != {shape}"
                )
    for name, shape in head_shapes.items():
        if tree["head"][name].shape != shape:
            raise ValueError(f"head.{name}: shape {tree['head'][name].shape} != {shape}")
    return params_from_jax(tree, device=device)
