"""Load a training snapshot back into live objects (counterpart of
nasa_niswan_tpu/evalx/snapshot.py).

The train <-> eval contract is the ``configurations.json`` the trainer
writes and the ``epoch-NNN/`` checkpoints beside it.  ``load_snapshot``
rebuilds the model, the period's dataset and the parameters from a run
directory written by either package's trainer (the two share the
configuration keys and the checkpoint layout), for the evaluation CLI
(``python -m nasa_niswan_tpu_torch.evalx``) and the serving CLI
(``python -m nasa_niswan_tpu_torch.rollout``), for every snapshot kind:
the ConvLSTM's (configs #1-#3) and the single-step UNet and PIX2PIX
families', whose UNet-6ch kind runs the closed loop.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class LoadedSnapshot:
    """Everything a snapshot consumer needs, rebuilt from a run dir."""

    cfg: Any  # TrainConfig
    bundle: Any  # models.registry ModelBundle
    dataset: Any  # the period's dataset (Seq2Seq, Sequence or SingleStep)
    params: Any
    eval_state: Any  # model state for eval (the UNet's BatchNorm statistics)
    meta: dict  # checkpoint metadata (epoch, lr, ...)
    static: Optional[np.ndarray]  # static-attribute channels or None
    n_forcing: int  # dynamic forcing channels (5, or 3*levels+2 fused)
    closed_loop: bool  # seq2seq feedback snapshot
    feedback_single: bool  # UNet-6ch feedback snapshot
    padded_shape: Tuple[int, int]


def load_snapshot(
    run_dir: str, *, epoch: Optional[int] = None, period: str = "test", device="cuda",
) -> LoadedSnapshot:
    """Rebuild model + dataset + checkpoint parameters from ``run_dir``, the
    parameters on ``device``.  Mirrors the training CLI's datasets: config
    #2 (``--levels`` fusion) and config #3 (``--mode seq2seq``) included."""
    from nasa_niswan_tpu_torch.data.dataset import (
        Seq2SeqDataset,
        SequenceDataset,
        SingleStepDataset,
    )
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.__main__ import load_data
    from nasa_niswan_tpu_torch.train.checkpoint import latest_epoch_dir, load_checkpoint
    from nasa_niswan_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(os.path.join(run_dir, "configurations.json"))
    cfg.snapshot_dir = run_dir
    bundle = build_model(
        cfg.model, in_channels=cfg.in_channels, hidden_channels=cfg.hidden_channels,
        kernel_sizes=cfg.kernel_size, compute_dtype=cfg.compute_dtype,
        unet_features=cfg.unet_features, pix2pix_features=cfg.pix2pix_features,
    )
    data = load_data(cfg)  # fused when cfg.levels > 1
    n_forcing = 3 * cfg.levels + 2 if cfg.levels > 1 else 5
    closed_loop = cfg.mode == "seq2seq" and bundle.is_sequence
    if closed_loop:
        dataset = Seq2SeqDataset(
            data, period=period, species=cfg.species, sequence_length=cfg.sequence_length,
        )
    elif bundle.is_sequence:
        kw = {} if cfg.levels > 1 else {"in_channels": cfg.in_channels}
        dataset = SequenceDataset(
            data, period=period, species=cfg.species,
            sequence_length=cfg.sequence_length, **kw,
        )
    else:
        dataset = SingleStepDataset(
            data, period=period, species=cfg.species, in_channels=cfg.in_channels,
            transform=cfg.transform,
        )

    ckpt_dir = (
        os.path.join(run_dir, f"epoch-{epoch:03d}") if epoch is not None
        else latest_epoch_dir(run_dir)
    )
    if ckpt_dir is None:
        raise SystemExit(f"no epoch-NNN checkpoint under {run_dir}")
    template, tmpl_state = bundle.init(torch.Generator().manual_seed(cfg.seed), device)
    params, _, eval_state, meta = load_checkpoint(ckpt_dir, template,
                                                  state_template=tmpl_state)

    # static-attribute channels ride above the forcing stack and the
    # feedback channel (seq2seq mode; a 6-channel single-step snapshot,
    # which gets the closed loop)
    feedback_single = bundle.family == "UNet" and cfg.in_channels == 6
    n_static = cfg.in_channels - n_forcing - (1 if closed_loop or feedback_single else 0)
    static = (
        data["static"][:n_static]
        if n_static > 0 and isinstance(data, dict) and "static" in data
        else None
    )
    return LoadedSnapshot(
        cfg=cfg, bundle=bundle, dataset=dataset, params=params, eval_state=eval_state,
        meta=meta, static=static, n_forcing=n_forcing, closed_loop=closed_loop,
        feedback_single=feedback_single, padded_shape=tuple(cfg.input_size),
    )
