"""Training entry point: ``python -m nasa_niswan_tpu_torch.train [flags]``
(counterpart of ``python -m nasa_niswan_tpu.train``, windowed mode).

Writes ``configurations.json`` to the snapshot dir, trains on the device
named by ``--device`` (default ``cuda``; there is no silent fall back to the
CPU), checkpoints in ``epoch-NNN`` directories and writes ``logger.npy``.
Data is the synthetic fixture or a packed ``.npz``; resume through
``--use-checkpoint --restore-from DIR`` or ``--auto-resume``.  Not ported
yet: ``--mode seq2seq``, the 3-D level fusion (``--levels`` > 1), the
``.nc`` reader and data parallelism.
"""

from __future__ import annotations

import numpy as np
import torch

from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
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


def load_data(config: TrainConfig) -> dict:
    if config.data_path:
        if not config.data_path.endswith(".npz"):
            raise NotImplementedError(
                f"{config.data_path}: only a packed .npz is read so far"
            )
        with np.load(config.data_path) as f:
            return dict(f)
    return synthetic_e33oma_90d(
        species=config.species, T=config.synthetic_steps, nlev=config.levels,
        H=config.synthetic_grid[0], W=config.synthetic_grid[1], seed=config.seed,
    )


def build_datasets(config: TrainConfig, data):
    if config.levels > 1:
        raise NotImplementedError("--levels > 1 (3-D level fusion) is not ported yet")

    def make(period):
        return SequenceDataset(
            data, period=period, species=config.species,
            sequence_length=config.sequence_length, in_channels=config.in_channels,
        )

    return make("train"), make("val")


def main(config: TrainConfig):
    if config.mode != "windowed":
        raise NotImplementedError(f"--mode {config.mode} is not ported yet")
    device = resolve_device(config.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{config.model} deployed on {kind}")
    data = load_data(config)
    bundle = build_model(
        config.model,
        in_channels=config.in_channels,
        hidden_channels=config.hidden_channels,
        kernel_sizes=config.kernel_size,
        compute_dtype=config.compute_dtype,
    )
    train_ds, val_ds = build_datasets(config, data)
    n_static = config.in_channels - 5
    static = data["static"][:n_static] if n_static > 0 else None

    init_params = init_opt_state = None
    start_epoch = 1
    restore_dir = None
    if config.auto_resume:
        restore_dir = latest_epoch_dir(config.snapshot_dir)
    elif config.use_checkpoint:
        restore_dir = config.restore_from
    if restore_dir:
        template, _ = bundle.init(torch.Generator().manual_seed(config.seed), device)
        init_params, init_opt_state, meta = load_checkpoint(
            restore_dir, template, lr=config.learning_rate
        )
        if config.auto_resume and meta.get("epoch"):
            start_epoch = int(meta["epoch"]) + 1
        print("Number of Epochs:", meta.get("epoch"))
        print("Learning Rate:", meta.get("learning_rate"))

    return fit(
        bundle, train_ds, val_ds, config, device=device, static=static,
        init_params=init_params, init_opt_state=init_opt_state,
        start_epoch=start_epoch,
    )


if __name__ == "__main__":
    cfg = parse_args()
    cfg.dump()
    print("Working Directory:", cfg.snapshot_dir)
    main(cfg)
