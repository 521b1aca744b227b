"""Checkpoint I/O in the JAX package's layout (counterpart of
nasa_niswan_tpu/train/checkpoint.py), so a checkpoint written by either
package loads in the other.

Layout: every N epochs a directory ``<snapshot_dir>/epoch-NNN/`` holding
``checkpoint.npz`` (flattened leaves) and ``checkpoint_meta.json`` (leaf
counts, lr, epoch), written tmp-then-rename, npz first and meta last, so a
directory is committed once its meta exists.

Leaves are in ``jax.tree_util`` flatten order:

* params ``p<i>``: per cell ``b, w_h, w_x``, then the head's ``b, w``
  (``param_leaves``);
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

CKPT_FILE = "checkpoint.npz"
META_FILE = "checkpoint_meta.json"
_N_HYPER = 6  # count, b1, b2, eps, eps_root, learning_rate


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tree's leaves in JAX flatten order (sorted keys)."""
    leaves = [cell[k] for cell in params["cells"] for k in ("b", "w_h", "w_x")]
    return leaves + [params["head"][k] for k in ("b", "w")]


def _from_leaves(n_cells: int, leaves) -> Dict[str, Any]:
    """Inverse of ``param_leaves``."""
    it = iter(leaves)
    cells = []
    for _ in range(n_cells):
        b, w_h, w_x = next(it), next(it), next(it)
        cells.append({"w_x": w_x, "w_h": w_h, "b": b})
    b, w = next(it), next(it)
    return {"cells": cells, "head": {"w": w, "b": b}}


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
) -> str:
    os.makedirs(directory, exist_ok=True)
    p_leaves = [_np(t) for t in param_leaves(params)]
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
    ckpt_tmp = os.path.join(directory, CKPT_FILE + ".tmp")
    with open(ckpt_tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(ckpt_tmp, os.path.join(directory, CKPT_FILE))
    meta = {
        "n_params": len(p_leaves),
        "n_opt": len(o_leaves),
        "n_state": 0,
        "learning_rate": learning_rate,
        "epoch": epoch,
        "params_treedef": "ConvLSTM {cells: [{b, w_h, w_x}], head: {b, w}}",
        "opt_treedef": "inject_hyperparams(adam) (count, hyperparams, (adam count, mu, nu))"
        if o_leaves else "",
        "state_treedef": "",
    }
    meta_tmp = os.path.join(directory, META_FILE + ".tmp")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, os.path.join(directory, META_FILE))
    return directory


def load_checkpoint(directory: str, params_template, *, lr: Optional[float] = None):
    """Restore ``(params, opt_state, meta)`` from a checkpoint directory of
    either package.  ``params`` follows the template's shapes and device,
    leaves requiring grad; ``opt_state`` is None when the file holds no
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
    for a, t in zip(p_leaves, tmpl):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{directory}: leaf shape {a.shape} != {tuple(t.shape)}")
    params = _from_leaves(len(params_template["cells"]), [
        torch.tensor(a, dtype=t.dtype, device=t.device).requires_grad_(True)
        for a, t in zip(p_leaves, tmpl)
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
    return params, opt_state, meta


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
