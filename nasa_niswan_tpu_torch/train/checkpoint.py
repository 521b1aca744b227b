"""Checkpoint I/O in the JAX package's layout (counterpart of
nasa_niswan_tpu/train/checkpoint.py), so a checkpoint written by either
package loads in the other.

Layout: every N epochs a directory ``<snapshot_dir>/epoch-NNN/`` holding
``checkpoint.npz`` (flattened leaves) and ``checkpoint_meta.json`` (leaf
counts, lr, epoch), written tmp-then-rename, npz first and meta last, so a
directory is committed once its meta exists.

Leaves are in ``jax.tree_util`` flatten order (``bridge.tree_leaves``:
dict values by sorted key), for every model family:

* params ``p<i>``: for the ConvLSTM, per cell ``b, w_h, w_x``, then the
  head's ``b, w`` (``param_leaves``);
* model state ``s<i>``: the UNet's BatchNorm running statistics, ``mean``
  and ``var`` per norm; none for the stateless families;
* optimizer ``o<i>``: the state of ``optax.inject_hyperparams(optax.adam)``,
  ``count, b1, b2, eps, eps_root, learning_rate`` (the hyperparameters,
  sorted), then Adam's ``count``, ``mu`` leaves and ``nu`` leaves in the
  params' order.  ``torch.optim.Adam`` keeps the same moments as
  ``exp_avg`` / ``exp_avg_sq`` and the count as ``step``.

Restore precedence for lr: an explicit ``lr`` argument, else the stored lr.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves, tree_unflatten

CKPT_FILE = "checkpoint.npz"
META_FILE = "checkpoint_meta.json"
_N_HYPER = 6  # count, b1, b2, eps, eps_root, learning_rate
_STATE_UNSET = object()  # "no state wanted", unlike a None template


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tree's leaves in JAX flatten order (sorted keys)."""
    return tree_leaves(params)


def _describe(tree) -> str:
    """The tree's structure in brief, e.g. ``{cells: [{b, w_h, w_x}], head:
    {b, w}}``: the meta's treedef, which no reader parses."""
    if isinstance(tree, dict):
        return "{" + ", ".join(
            k if isinstance(tree[k], torch.Tensor) else f"{k}: {_describe(tree[k])}"
            for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + (_describe(tree[0]) if tree else "") + "]"
    return "*"


def optimizer_state(optimizer: torch.optim.Optimizer, params) -> Dict[str, Any]:
    """Adam's step count and moments, in ``param_leaves`` order (zeros for a
    parameter that has taken no step)."""
    leaves = param_leaves(params)
    states = [optimizer.state.get(p, {}) for p in leaves]
    step = max((int(s["step"]) for s in states if "step" in s), default=0)
    return {
        "step": step,
        "exp_avg": [s.get("exp_avg", torch.zeros_like(p)) for s, p in zip(states, leaves)],
        "exp_avg_sq": [s.get("exp_avg_sq", torch.zeros_like(p))
                       for s, p in zip(states, leaves)],
    }


def load_optimizer_state(optimizer: torch.optim.Optimizer, params,
                         opt_state: Dict[str, Any]) -> None:
    """Set Adam's step count and moments from ``opt_state`` (as
    ``load_checkpoint`` or ``optimizer_state`` return it)."""
    for p, m, v in zip(param_leaves(params), opt_state["exp_avg"],
                       opt_state["exp_avg_sq"]):
        optimizer.state[p] = {
            "step": torch.tensor(float(opt_state["step"]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(m, dtype=p.dtype).to(p.device).clone(),
            "exp_avg_sq": torch.as_tensor(v, dtype=p.dtype).to(p.device).clone(),
        }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(
    directory: str,
    params,
    optimizer: Optional[torch.optim.Optimizer] = None,
    *,
    learning_rate: Optional[float] = None,
    epoch: Optional[int] = None,
    model_state=None,
) -> str:
    """``model_state`` (the UNet's BatchNorm statistics) is written as the
    ``s<i>`` leaves; without it an evaluation or a resume would normalize
    by fresh (0, 1) statistics."""
    os.makedirs(directory, exist_ok=True)
    p_leaves = [_np(t) for t in param_leaves(params)]
    s_leaves = [_np(t) for t in tree_leaves(model_state)]
    o_leaves: List[np.ndarray] = []
    if optimizer is not None:
        group = optimizer.param_groups[0]
        st = optimizer_state(optimizer, params)
        count = np.asarray(st["step"], np.int32)
        hyper = (group["betas"][0], group["betas"][1], group["eps"], 0.0,
                 group["lr"] if learning_rate is None else learning_rate)
        o_leaves = [count, *(np.asarray(h, np.float32) for h in hyper), count]
        o_leaves += [_np(t) for t in st["exp_avg"] + st["exp_avg_sq"]]
    arrays = {f"p{i}": a for i, a in enumerate(p_leaves)}
    arrays.update({f"o{i}": a for i, a in enumerate(o_leaves)})
    arrays.update({f"s{i}": a for i, a in enumerate(s_leaves)})
    ckpt_tmp = os.path.join(directory, CKPT_FILE + ".tmp")
    with open(ckpt_tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(ckpt_tmp, os.path.join(directory, CKPT_FILE))
    meta = {
        "n_params": len(p_leaves),
        "n_opt": len(o_leaves),
        "n_state": len(s_leaves),
        "learning_rate": learning_rate,
        "epoch": epoch,
        "params_treedef": ("ConvLSTM " if "cells" in params else "") + _describe(params),
        "opt_treedef": "inject_hyperparams(adam) (count, hyperparams, (adam count, mu, nu))"
        if o_leaves else "",
        "state_treedef": _describe(model_state) if s_leaves else "",
    }
    meta_tmp = os.path.join(directory, META_FILE + ".tmp")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, os.path.join(directory, META_FILE))
    return directory


def load_checkpoint(directory: str, params_template, *, lr: Optional[float] = None,
                    state_template: Any = _STATE_UNSET):
    """Restore ``(params, opt_state, meta)`` from a checkpoint directory of
    either package, or ``(params, opt_state, model_state, meta)`` when a
    ``state_template`` is given (None for a stateless family; a checkpoint
    without state leaves gives back the template).  ``params`` follows the
    template's shapes and device, leaves requiring grad; the state follows
    its template's; ``opt_state`` is None when the file holds no
    optimizer, else ``{"step", "exp_avg", "exp_avg_sq"}`` for
    ``load_optimizer_state``; ``meta["learning_rate"]`` is ``lr`` if given,
    else the stored lr."""
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    tmpl = param_leaves(params_template)
    n = len(tmpl)
    if meta["n_params"] != n:
        raise ValueError(
            f"{directory}: {meta['n_params']} parameter leaves, the model has {n}"
        )
    with np.load(os.path.join(directory, CKPT_FILE)) as data:
        p_leaves = [data[f"p{i}"] for i in range(n)]
        o_leaves = [data[f"o{i}"] for i in range(meta["n_opt"])]
        s_leaves = [data[f"s{i}"] for i in range(meta.get("n_state") or 0)]
    params = tree_unflatten(params_template, [
        torch.tensor(a, dtype=t.dtype, device=t.device).requires_grad_(True)
        for a, t in zip(_checked(directory, p_leaves, tmpl), tmpl)
    ])
    opt_state = None
    if o_leaves:
        if len(o_leaves) != _N_HYPER + 1 + 2 * n:
            raise ValueError(
                f"{directory}: {len(o_leaves)} optimizer leaves; Adam over {n} "
                f"parameters has {_N_HYPER + 1 + 2 * n}"
            )
        mom = o_leaves[_N_HYPER + 1 :]
        opt_state = {"step": int(o_leaves[_N_HYPER]), "exp_avg": mom[:n],
                     "exp_avg_sq": mom[n:]}
    meta["learning_rate"] = lr if lr is not None else meta.get("learning_rate")
    if state_template is _STATE_UNSET:
        return params, opt_state, meta
    model_state = state_template
    if s_leaves and state_template is not None:
        s_tmpl = tree_leaves(state_template)
        if len(s_leaves) != len(s_tmpl):
            raise ValueError(f"{directory}: {len(s_leaves)} state leaves, the model "
                             f"has {len(s_tmpl)}")
        model_state = tree_unflatten(state_template, [
            torch.tensor(a, dtype=t.dtype, device=t.device)
            for a, t in zip(_checked(directory, s_leaves, s_tmpl), s_tmpl)
        ])
    return params, opt_state, model_state, meta


def _checked(directory: str, arrays, template):
    for a, t in zip(arrays, template):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{directory}: leaf shape {a.shape} != {tuple(t.shape)}")
    return arrays


def latest_epoch_dir(snapshot_dir: str) -> Optional[str]:
    """Most recent committed ``epoch-NNN`` directory (both files present)."""
    if not os.path.isdir(snapshot_dir):
        return None
    dirs = sorted(
        d for d in os.listdir(snapshot_dir)
        if d.startswith("epoch-")
        and os.path.isfile(os.path.join(snapshot_dir, d, META_FILE))
        and os.path.isfile(os.path.join(snapshot_dir, d, CKPT_FILE))
    )
    return os.path.join(snapshot_dir, dirs[-1]) if dirs else None
