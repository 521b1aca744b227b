"""Training entry point: ``python -m nasa_niswan_tpu_torch.train [flags]``
(counterpart of ``python -m nasa_niswan_tpu.train``).

Writes ``configurations.json`` to the snapshot dir, trains on the device
named by ``--device`` (default ``cuda``; there is no silent fall back to the
CPU), checkpoints in ``epoch-NNN`` directories and writes ``logger.npy``.
Data is the synthetic fixture, a packed ``.npz`` or a packed
E33OMA-90Days-style ``.nc`` (data/netcdf.load_90days_nc); ``--levels L`` > 1
fuses the first L levels of u/v/omega into channels (config #2 at L = 20:
C = 3 L + 2, data/fusion.fuse_levels).  Two modes:

* ``--mode windowed`` (default): sliding-window training of the ConvLSTM,
  or one-frame samples (``SingleStepDataset``) for the single-step
  families ``--model UNet-...`` (``--unet-features``; ``--in-channels 6``
  adds the previous step's concentration as a feedback channel) and
  ``--model PIX2PIX-...`` (``--pix2pix-features``; maps padded to a
  multiple of 256, e.g. ``--input-size 256 256``); resume through
  ``--use-checkpoint --restore-from DIR`` or ``--auto-resume`` (the UNet's
  BatchNorm statistics included); ``--precompute-input-conv`` trains the
  ConvLSTM with the hoisted input conv (the per-cell route), otherwise the
  whole-scan BPTT;
* ``--mode seq2seq`` (config #3): scheduled-sampling training through the
  feedback channel; ``--use-checkpoint --restore-from DIR`` fine-tunes a
  windowed snapshot (the canonical protocol: windowed train, seq2seq
  fine-tune, rollout); ``--schedule-k`` sets the teacher-forcing decay.

``--dp-devices N`` > 1 trains either mode data-parallel on N ranks, one
device each (``cuda:0`` .. ``cuda:N-1``, or N CPU processes with
``--device cpu``), started by ``parallel/launch.spawn`` (or joined under
torchrun): each rank runs its share of every batch, gradients are averaged
by one all-reduce per step (parallel/dp.py), rank 0 writes the snapshot.
The single-step families are refused there: their data parallelism (global
BatchNorm statistics) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

import os

from nasa_niswan_tpu_torch.data.dataset import (
    Seq2SeqDataset,
    SequenceDataset,
    SingleStepDataset,
)
from nasa_niswan_tpu_torch.data.fusion import fuse_levels
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.train.checkpoint import latest_epoch_dir, load_checkpoint
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args
from nasa_niswan_tpu_torch.train.loop import fit


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible; pass --device cpu to "
            "train on the CPU"
        )
    return device


def load_data(config: TrainConfig):
    """The packed data dict, or the fused (frames, targets) stack when
    ``--levels`` > 1."""
    if config.data_path and config.data_path.endswith(".nc"):
        from nasa_niswan_tpu_torch.data.netcdf import load_90days_nc

        data = load_90days_nc(
            config.data_path, levels=config.levels if config.levels > 1 else None)
    elif config.data_path:
        with np.load(config.data_path) as f:
            data = dict(f)
    else:
        data = synthetic_e33oma_90d(
            species=config.species, T=config.synthetic_steps, nlev=config.levels,
            H=config.synthetic_grid[0], W=config.synthetic_grid[1], seed=config.seed,
        )
    if config.levels > 1:
        # config #2: the 3-D meteorology levels become channels (C = 3L+2)
        return fuse_levels(data, config.species, levels=config.levels)
    return data


def build_datasets(config: TrainConfig, bundle, data):
    """The train and val datasets: windows for a sequence model, one-frame
    samples for a single-step one."""
    def make(period):
        if not bundle.is_sequence:
            return SingleStepDataset(
                data, period=period, species=config.species,
                in_channels=config.in_channels, transform=config.transform,
            )
        return SequenceDataset(
            data, period=period, species=config.species,
            sequence_length=config.sequence_length, in_channels=config.in_channels,
        )

    return make("train"), make("val")


def run_seq2seq(config: TrainConfig, data, device: torch.device):
    """Config #3: scheduled-sampling training through the feedback channel
    (``--mode seq2seq``), with ``remat`` off as in the JAX package: every
    cell differentiates through the per-cell route."""
    from nasa_niswan_tpu_torch.rollout.seq2seq import fit_seq2seq

    if config.family != "LSTM":
        raise ValueError("--mode seq2seq drives the recurrent (LSTM) family")

    def make(period):
        return Seq2SeqDataset(
            data, period=period, species=config.species,
            sequence_length=config.sequence_length,
        )

    train_ds, val_ds = make("train"), make("val")
    model_cfg = ConvLSTMConfig(
        in_channels=config.in_channels,
        hidden_channels=tuple(config.hidden_channels),
        kernel_sizes=tuple(config.kernel_size),
        compute_dtype=config.compute_dtype,
    )
    params = convlstm_init(
        torch.Generator().manual_seed(config.seed), model_cfg, device=device
    )
    for t in [t for cell in params["cells"] for t in cell.values()] + list(
            params["head"].values()):
        t.requires_grad_(True)
    if config.use_checkpoint:
        # fine-tune from a windowed-training checkpoint
        params, _, _ = load_checkpoint(
            config.restore_from, params, lr=config.learning_rate
        )
    grid = tuple(data[1].shape[-2:]) if isinstance(data, tuple) else tuple(
        data[f"{config.species}_conc"].shape[-2:]
    )
    params, optimizer, history = fit_seq2seq(
        model_cfg, params, train_ds, dp_devices=config.dp_devices,
        val_dataset=val_ds,
        padded_shape=tuple(config.input_size),
        grid_shape=grid,
        num_epochs=config.num_epochs,
        batch_size=config.batch_size,
        learning_rate=config.learning_rate,
        betas=tuple(config.betas),
        schedule_k=config.schedule_k,
        seed=config.seed,
        snapshot_dir=config.snapshot_dir,
        checkpoint_every=config.checkpoint_every,
    )
    # logger.npy: loss / train R2 / val R2, the reference's three arrays
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        os.makedirs(config.snapshot_dir, exist_ok=True)
        with open(os.path.join(config.snapshot_dir, "logger.npy"), "wb") as f:
            np.save(f, np.array([h["loss"] for h in history]))
            np.save(f, np.array([h["r2"] for h in history]))
            np.save(f, np.array([h.get("r2_val", np.nan) for h in history]))
    return {"params": params, "optimizer": optimizer, "history": history}


def main(config: TrainConfig):
    if config.dp_devices > 1:
        return run_data_parallel(config)
    device = resolve_device(config.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{config.model} deployed on {kind}")
    return train(config, device)


def run_data_parallel(config: TrainConfig):
    """``--dp-devices N``: N ranks, each running ``train`` on its own device;
    returns rank 0's result (parameters on the CPU, no optimizer)."""
    from nasa_niswan_tpu_torch.parallel import launch

    n = config.dp_devices
    if config.mode == "windowed" and config.family != "LSTM":
        raise SystemExit(
            f"--dp-devices {n}: data-parallel training of the single-step families "
            f"({config.family}: UNet BatchNorm state, pix2pix, the GAN step) with "
            "global-batch statistics is not ported (ROADMAP, queue A: DP of the "
            "stateful single-step families); train them with --dp-devices 1")
    if config.batch_size % n:
        raise SystemExit(f"--dp-devices {n}: --batch-size {config.batch_size} must be "
                         "divisible by it")
    device_type = torch.device(config.device).type
    kind = torch.cuda.get_device_name(0) if device_type == "cuda" and \
        torch.cuda.is_available() else device_type
    print(f"{config.model} deployed on {n} x {kind}")
    return launch.spawn(_train_rank, n, device_type, config)[0]


def _train_rank(rank: int, config: TrainConfig):
    from nasa_niswan_tpu_torch.bridge import tree_map
    from nasa_niswan_tpu_torch.parallel.mesh import rank_device

    out = train(config, rank_device(torch.device(config.device).type))
    if rank:
        return None
    out = {k: v for k, v in out.items() if k != "optimizer"}
    out["params"] = tree_map(lambda t: t.detach().cpu(), out["params"])
    return out


def train(config: TrainConfig, device: torch.device):
    """Build the data and the model and train on ``device`` (a rank's,
    when ``config.dp_devices`` > 1)."""
    data = load_data(config)
    if config.mode == "seq2seq":
        return run_seq2seq(config, data, device)
    bundle = build_model(
        config.model,
        in_channels=config.in_channels,
        hidden_channels=config.hidden_channels,
        kernel_sizes=config.kernel_size,
        compute_dtype=config.compute_dtype,
        precompute_input_conv=config.precompute_input_conv,
        unet_features=config.unet_features,
        pix2pix_features=config.pix2pix_features,
    )
    train_ds, val_ds = build_datasets(config, bundle, data)
    # static channels apply to the surface configs only: every channel of
    # the fused stack is dynamic, and a 6-channel single-step model's 6th
    # channel is the feedback channel, which SingleStepDataset provides
    n_static = config.in_channels - 5 if config.levels == 1 else 0
    if not bundle.is_sequence and config.in_channels == 6:
        n_static = 0
    static = data["static"][:n_static] if n_static > 0 else None

    init_params = init_state = init_opt_state = None
    start_epoch = 1
    restore_dir = None
    if config.auto_resume:
        restore_dir = latest_epoch_dir(config.snapshot_dir)
    elif config.use_checkpoint:
        restore_dir = config.restore_from
    if restore_dir:
        template, tmpl_state = bundle.init(
            torch.Generator().manual_seed(config.seed), device)
        init_params, init_opt_state, init_state, meta = load_checkpoint(
            restore_dir, template, lr=config.learning_rate, state_template=tmpl_state
        )
        if config.auto_resume and meta.get("epoch"):
            start_epoch = int(meta["epoch"]) + 1
        print("Number of Epochs:", meta.get("epoch"))
        print("Learning Rate:", meta.get("learning_rate"))

    if config.dp_devices > 1:
        from nasa_niswan_tpu_torch.parallel.dp import fit_data_parallel

        run = fit_data_parallel
    else:
        run = fit
    return run(
        bundle, train_ds, val_ds, config, device=device, static=static,
        init_params=init_params, init_state=init_state,
        init_opt_state=init_opt_state, start_epoch=start_epoch,
    )


if __name__ == "__main__":
    cfg = parse_args()
    cfg.dump()
    print("Working Directory:", cfg.snapshot_dir)
    main(cfg)
