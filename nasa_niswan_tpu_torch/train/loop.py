"""Training loop: train and eval steps and the epoch driver (counterpart of
nasa_niswan_tpu/train/loop.py, single device).

* One train step holds the whole per-batch pipeline on the device:
  normalization, static channels and geophysical padding, the forward (the
  whole-scan BPTT route of models/convlstm.py, kernels B1/B2/B3 on the
  card), crop to the grid, MSE + L1 loss, the Adam update and the batch
  R^2.  Parameters are updated in place by ``torch.optim.Adam``.
* StepLR is applied by setting the optimizer's lr once per epoch.
* Epoch metrics accumulate as device scalars; one host sync per epoch.
* Batches come from ``DeviceWindowSource`` when the split's frame slabs
  fit on the device: the contiguous slab is uploaded once and each batch's
  windows are gathered on the device by start index.  Otherwise (or for a
  dataset without a slab, such as the lazy netCDF ones) they are streamed
  by ``data/pipeline.async_batches``: stacked in pinned memory by a
  producer thread and copied on a side stream while the step runs.
* Checkpoints every ``checkpoint_every`` epochs in the ``epoch-NNN`` layout
  (train/checkpoint.py), and ``logger.npy`` with the reference's three
  arrays at the end.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import crop_to_grid
from nasa_niswan_tpu_torch.data.dataset import Normalizer, make_preprocess_fn
from nasa_niswan_tpu_torch.data.pipeline import async_batches, batch_indices
from nasa_niswan_tpu_torch.evalx.metrics import r2
from nasa_niswan_tpu_torch.models.registry import ModelBundle
from nasa_niswan_tpu_torch.train.checkpoint import (
    load_optimizer_state,
    param_leaves,
    save_checkpoint,
)
from nasa_niswan_tpu_torch.train.schedule import step_lr


def make_optimizer(params, learning_rate: float,
                   betas: Tuple[float, float]) -> torch.optim.Adam:
    """Adam with the reference's betas and eps 1e-8 (optax ``adam``'s
    defaults: the same update up to rounding) over ``param_leaves(params)``."""
    return torch.optim.Adam(
        param_leaves(params), lr=learning_rate, betas=tuple(betas), eps=1e-8
    )


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def _forward_cropped(bundle: ModelBundle, params, state, x, grid_shape, *, training):
    pred, new_state = bundle.apply(params, state, x, training=training)
    return crop_to_grid(pred[..., 0], grid_shape), new_state


def make_loss_fn(bundle: ModelBundle, grid_shape: Tuple[int, int]) -> Callable:
    """The training loss, MSE + L1 on the cropped grid, as
    ``loss_fn(params, state, x, y) -> (loss, (pred, new_state))``."""

    def loss_fn(params, state, x, y):
        pred, new_state = _forward_cropped(
            bundle, params, state, x, grid_shape, training=True
        )
        loss = torch.mean((y - pred) ** 2) + torch.mean(torch.abs(y - pred))
        return loss, (pred, new_state)

    return loss_fn


def build_train_step_fn(
    bundle: ModelBundle,
    normalizer: Normalizer,
    optimizer: torch.optim.Optimizer,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
) -> Callable:
    """``step(params, state, x_raw, y_raw) -> (new_state, metrics)`` on
    device tensors: preprocess, loss, backward, one Adam update of
    ``params`` in place; metrics are device scalars ``loss`` and ``r2``."""
    preprocess = make_preprocess_fn(normalizer, padded_shape, static=static)
    loss_fn = make_loss_fn(bundle, grid_shape)

    def train_step(params, state, x_raw, y_raw):
        x, y = preprocess(x_raw, y_raw)
        optimizer.zero_grad(set_to_none=True)
        loss, (pred, new_state) = loss_fn(params, state, x, y)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "r2": r2(y, pred)}
        return new_state, metrics

    return train_step


def _device_of(params) -> torch.device:
    return param_leaves(params)[0].device


def make_train_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    optimizer: torch.optim.Optimizer,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
) -> Callable:
    """The train step for host batches (numpy or tensors), moved to the
    parameters' device."""
    inner = build_train_step_fn(
        bundle, normalizer, optimizer, padded_shape=padded_shape,
        grid_shape=grid_shape, static=static,
    )

    def step(params, state, x_raw, y_raw):
        dev = _device_of(params)
        return inner(params, state, torch.as_tensor(x_raw, device=dev),
                     torch.as_tensor(y_raw, device=dev))

    return step


def build_eval_step_fn(
    bundle: ModelBundle,
    normalizer: Normalizer,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = False,
) -> Callable:
    """``step(params, state, x_raw, y_raw) -> (per-sample R^2, pred)`` on
    device tensors, without grad (the reference evaluates bs=1 and averages
    per-sample scores); pred normalized, or in physical units when
    ``unnormalize``."""
    preprocess = make_preprocess_fn(normalizer, padded_shape, static=static)

    def eval_step(params, state, x_raw, y_raw):
        with torch.no_grad():
            x, y = preprocess(x_raw, y_raw)
            pred, _ = _forward_cropped(
                bundle, params, state, x, grid_shape, training=False
            )
            flat_p = pred.reshape(pred.shape[0], -1)
            flat_y = y.reshape(y.shape[0], -1)
            ss_res = torch.sum((flat_y - flat_p) ** 2, dim=1)
            ss_tot = torch.sum(
                (flat_y - torch.mean(flat_y, dim=1, keepdim=True)) ** 2, dim=1
            )
            per_sample_r2 = 1.0 - ss_res / ss_tot
            if unnormalize:
                pred = normalizer.unnormalize_y(pred)
        return per_sample_r2, pred

    return eval_step


def make_eval_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = False,
) -> Callable:
    """The eval step for host batches, moved to the parameters' device."""
    inner = build_eval_step_fn(
        bundle, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, unnormalize=unnormalize,
    )

    def step(params, state, x_raw, y_raw):
        dev = _device_of(params)
        return inner(params, state, torch.as_tensor(x_raw, device=dev),
                     torch.as_tensor(y_raw, device=dev))

    return step


class DeviceWindowSource:
    """Device-resident sliding-window batches for sequence training.

    The split's contiguous raw frame slab (``SequenceDataset.forcing_stream``)
    is uploaded once; each batch's windows are gathered on the device by
    start index, so per batch only a (B,) index vector crosses from the host.
    A full reference training year (17,520 x 5 x 90 x 144 f32) is 4.5 GB.
    """

    def __init__(self, dataset, device):
        frames, targets = dataset.forcing_stream()
        self.seq_len = dataset.seq_len
        self.n = len(dataset)
        self.device = torch.device(device)
        self.frames = torch.from_numpy(frames).to(self.device)  # (T_total, C, H, W)
        self.targets = torch.from_numpy(targets).to(self.device)  # (N, H, W)
        self._offsets = torch.arange(self.seq_len, device=self.device)

    def gather(self, starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) window starts -> ((B, T, C, H, W), (B, H, W))."""
        starts = torch.as_tensor(starts, dtype=torch.int64, device=self.device)
        return self.frames[starts[:, None] + self._offsets], self.targets[starts]


def make_device_train_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    optimizer: torch.optim.Optimizer,
    source: DeviceWindowSource,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
) -> Callable:
    """``step(params, state, starts) -> (new_state, metrics)`` with the batch
    gathered from the device-resident slab."""
    inner = build_train_step_fn(
        bundle, normalizer, optimizer, padded_shape=padded_shape,
        grid_shape=grid_shape, static=static,
    )

    def step(params, state, starts):
        return inner(params, state, *source.gather(starts))

    return step


def make_device_eval_step(
    bundle: ModelBundle,
    normalizer: Normalizer,
    source: DeviceWindowSource,
    *,
    padded_shape: Optional[Tuple[int, int]],
    grid_shape: Tuple[int, int] = (90, 144),
    static: Optional[np.ndarray] = None,
    unnormalize: bool = False,
) -> Callable:
    inner = build_eval_step_fn(
        bundle, normalizer, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, unnormalize=unnormalize,
    )

    def step(params, state, starts):
        return inner(params, state, *source.gather(starts))

    return step


def slabs_fit(datasets, device: torch.device) -> bool:
    """Whether the datasets have frame slabs (``forcing_stream``) and these
    take at most half the free memory of a CUDA device (the rest is the
    step's working set); on the CPU, whether they have slabs."""
    if not all(hasattr(ds, "forcing_stream") for ds in datasets):
        return False
    if device.type != "cuda":
        return True
    need = sum(
        ds[0][0].nbytes * (len(ds) + ds.seq_len) // ds.seq_len for ds in datasets
    )
    free, _ = torch.cuda.mem_get_info(device)
    return need <= free // 2


def _pad_batch(batch, bs: int):
    """A partial batch padded to ``bs`` by repeating its last sample."""
    n = batch[0].shape[0]
    if n == bs:
        return batch
    return tuple(torch.cat([a, a[-1:].expand(bs - n, *a.shape[1:])]) for a in batch)


def fit(
    bundle: ModelBundle,
    train_dataset,
    val_dataset,
    config,
    *,
    device,
    normalizer: Optional[Normalizer] = None,
    static: Optional[np.ndarray] = None,
    init_params=None,
    init_state=None,
    init_opt_state=None,
    start_epoch: int = 1,
    verbose: bool = True,
    device_resident: Optional[bool] = None,
) -> Dict[str, Any]:
    """Epoch driver with the reference's logging and checkpoints.

    ``device_resident``: True gathers each batch's windows on the device
    from uploaded frame slabs (``DeviceWindowSource``); False streams the
    batches through ``async_batches`` (pinned host buffers, copies on a
    side stream), in the same order; None takes the resident route when
    the slabs fit in half the device's free memory (``slabs_fit``), else
    streams.  The JAX package's 6 GiB threshold is a TPU policy and is not
    used.  Validation keeps the batch shape: a partial last batch is padded
    with its last sample and only the valid per-sample scores are kept.

    Returns {params, state, optimizer, logger, elapsed_s}; logger holds the
    three reference metric arrays (MSELoss, r2_score, r2_score_val).
    """
    since = time.time()
    device = torch.device(device)
    normalizer = normalizer or train_dataset.normalizer
    padded = tuple(config.input_size) if config.input_size else None
    grid_shape = tuple(train_dataset[0][1].shape[-2:])  # physical (lat, lon)

    if init_params is None:
        params, state = bundle.init(
            torch.Generator().manual_seed(config.seed), device
        )
    else:
        params, state = init_params, init_state
    optimizer = make_optimizer(params, config.learning_rate, tuple(config.betas))
    if init_opt_state is not None:
        load_optimizer_state(optimizer, params, init_opt_state)

    if device_resident is None:
        device_resident = slabs_fit((train_dataset, val_dataset), device)
    elif device_resident and not all(
            hasattr(ds, "forcing_stream") for ds in (train_dataset, val_dataset)):
        raise ValueError("device_resident=True needs datasets with frame slabs "
                         "(forcing_stream); stream the others")
    geo = dict(padded_shape=padded, grid_shape=grid_shape, static=static)
    if device_resident:
        train_src = DeviceWindowSource(train_dataset, device)
        val_src = DeviceWindowSource(val_dataset, device)
        train_step = make_device_train_step(
            bundle, normalizer, optimizer, train_src, **geo)
        eval_step = make_device_eval_step(bundle, normalizer, val_src, **geo)
    else:
        train_step = make_train_step(bundle, normalizer, optimizer, **geo)
        eval_step = make_eval_step(bundle, normalizer, **geo)

    logger = {"MSELoss": [], "r2_score": [], "r2_score_val": []}
    step_size, gamma = config.scheduler_config
    bs = config.batch_size
    for epoch in range(start_epoch, config.num_epochs + 1):
        set_learning_rate(
            optimizer, step_lr(config.learning_rate, step_size, gamma, epoch - 1)
        )
        losses, r2s = [], []
        if device_resident:  # batch_iterator's order, by window start
            batches = ((torch.as_tensor(idx),) for idx in batch_indices(
                train_src.n, bs, seed=config.seed, epoch=epoch))
        else:
            batches = async_batches(train_dataset, bs, shuffle=True, seed=config.seed,
                                    epoch=epoch, device=device)
        for batch in batches:
            state, metrics = train_step(params, state, *batch)
            losses.append(metrics["loss"])
            r2s.append(metrics["r2"])

        # val keeps the batch shape: a partial final batch is padded with its
        # last sample and only the valid per-sample scores are kept
        val_scores = []
        if device_resident:
            val_batches = ((torch.as_tensor(idx),) for idx in batch_indices(
                val_src.n, bs, shuffle=False, drop_last=False))
        else:
            val_batches = async_batches(val_dataset, bs, shuffle=False,
                                        drop_last=False, device=device)
        for batch in val_batches:
            n_valid = batch[0].shape[0]
            per_sample, _ = eval_step(params, state, *_pad_batch(batch, bs))
            val_scores.append(per_sample[:n_valid])

        logger["MSELoss"].append(float(torch.stack(losses).mean()))
        logger["r2_score"].append(float(torch.stack(r2s).mean()))
        logger["r2_score_val"].append(float(torch.cat(val_scores).mean()))
        if verbose:
            print(
                f"Epoch: {epoch}, Loss: {logger['MSELoss'][-1]:.5f}, "
                f"R2T: {logger['r2_score'][-1]:.5f}, "
                f"R2V: {logger['r2_score_val'][-1]:.5f}"
            )

        if config.checkpoint_every and epoch % config.checkpoint_every == 0:
            lr_now = step_lr(config.learning_rate, step_size, gamma, epoch - 1)
            save_checkpoint(
                os.path.join(config.snapshot_dir, f"epoch-{epoch:03d}"),
                params, optimizer, learning_rate=lr_now, epoch=epoch,
            )
            if verbose:
                print("Learning Rate:", [lr_now])

    # reference logger.npy: three consecutive np.save's in one file
    os.makedirs(config.snapshot_dir, exist_ok=True)
    with open(os.path.join(config.snapshot_dir, "logger.npy"), "wb") as f:
        np.save(f, np.array(logger["MSELoss"]))
        np.save(f, np.array(logger["r2_score"]))
        np.save(f, np.array(logger["r2_score_val"]))

    elapsed = time.time() - since
    if verbose:
        print(f"Training complete in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return {
        "params": params,
        "state": state,
        "optimizer": optimizer,
        "logger": logger,
        "elapsed_s": elapsed,
    }
