"""Weight bridge between the JAX package's trees and the port's.

Both packages hold every model as the same tree of nested dicts and lists
with one array per leaf, under the same names: the ConvLSTM as
``{"cells": [{"w_x", "w_h", "b"}, ...], "head": {"w", "b"}}``, the UNet and
the pix2pix networks as their ``enc1``, ``dec1``, ``bottleneck``, ...
trees, and the UNet's BatchNorm running statistics as a state tree of the
same kind.  Kernels are HWIO (a transposed conv's ``(kh, kw, out, in)``)
in both, so the bridge converts leaves and nothing is transposed; the
round trip is bit-exact.

``tree_leaves`` is ``jax.tree_util``'s flatten order (dict values by
sorted key, list items in order, ``None`` an empty subtree), the order of
the ``p<i>`` / ``s<i>`` leaves in a checkpoint of either package.
``load_jax_checkpoint`` reads the ``checkpoint.npz`` that the JAX
package's ``train/checkpoint.save_checkpoint`` writes, so a JAX-trained
snapshot of any family serves in the port.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig

CKPT_FILE = "checkpoint.npz"


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples in ``jax.tree_util``
    flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(template: Any, leaves) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order); the inverse of ``tree_leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def params_from_jax(tree: Any, *, device=None) -> Any:
    """A JAX tree (numpy or jax arrays) -> the port's tree of torch tensors
    (copies, same dtype and layout); parameters and model state alike.  A
    ConvLSTM tree's dicts come in the key order the port's init writes
    (``w_x, w_h, b``; ``w, b``), whatever order the JAX tree's are in."""
    out = tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)
    if isinstance(out, dict) and "cells" in out:
        out = {"cells": [{k: c[k] for k in ("w_x", "w_h", "b")} for c in out["cells"]],
               "head": {k: out["head"][k] for k in ("w", "b")}}
    return out


def params_to_jax(params: Any) -> Any:
    """The port's tree -> the JAX package's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def _convlstm_template(config: ConvLSTMConfig):
    cells = []
    in_ch = config.in_channels
    for hid, k in zip(config.hidden_channels, config.kernel_sizes):
        cells.append({"w_x": torch.empty(k, k, in_ch, 4 * hid),
                      "w_h": torch.empty(k, k, hid, 4 * hid), "b": torch.empty(4 * hid)})
        in_ch = hid
    return {"cells": cells, "head": {"w": torch.empty(1, 1, in_ch, config.out_channels),
                                     "b": torch.empty(config.out_channels)}}


def _read_leaves(data, path: str, prefix: str, template) -> List[np.ndarray]:
    want = tree_leaves(template)
    n = len(want)
    leaves = []
    for i, t in enumerate(want):
        if f"{prefix}{i}" not in data:
            raise ValueError(f"{path}: no leaf {prefix}{i}; the template has {n}")
        a = np.asarray(data[f"{prefix}{i}"])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{path}: leaf {prefix}{i} shape {a.shape} != {tuple(t.shape)}")
        leaves.append(a)
    if f"{prefix}{n}" in data:
        raise ValueError(f"{path} holds more than {n} {prefix}-leaves: another model")
    return leaves


def load_jax_checkpoint(path: str, template, *, state_template: Optional[Any] = None,
                        device=None):
    """Read the parameters of a JAX ``checkpoint.npz`` (``path`` is the file
    or its epoch directory) into a tree shaped like ``template``: a
    parameter tree of any family, or a ``ConvLSTMConfig``.  Raises if the
    leaves do not match it.  With a ``state_template`` (the UNet's
    BatchNorm statistics) returns ``(params, state)``, the state read from
    the ``s<i>`` leaves."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_FILE)
    if isinstance(template, ConvLSTMConfig):
        template = _convlstm_template(template)
    with np.load(path) as data:
        params = tree_unflatten(template, _read_leaves(data, path, "p", template))
        state = None if state_template is None else tree_unflatten(
            state_template, _read_leaves(data, path, "s", state_template))
    params = params_from_jax(params, device=device)
    if state_template is None:
        return params
    return params, params_from_jax(state, device=device)
