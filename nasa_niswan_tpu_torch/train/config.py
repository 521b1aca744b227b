"""Run configuration: typed dataclass + CLI + configurations.json contract
(counterpart of nasa_niswan_tpu/train/config.py).

The reference serializes its argparse namespace to
``<snapshot_dir>/configurations.json`` and the evaluation reloads it, so the
reference's keys are kept verbatim.  A file written by either package loads
in the other: unknown keys are ignored on read, missing ones take their
defaults.  ``precompute_input_conv`` (the hoisted input conv, which trains
through the per-cell route), ``schedule_k`` (the seq2seq teacher-forcing
decay), ``unet_features`` and ``pix2pix_features`` (the single-step
families' widths) and ``dp_devices`` (data-parallel ranks, one device
each) mean what they mean there.  The JAX package's other TPU settings
(``cell_impl``, ``checkpoint_backend``) have no counterpart; ``device`` is
the port's own (with ``dp_devices`` > 1, its type: rank r trains on
``cuda:r``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

_TUPLES = ("hidden_channels", "kernel_size", "input_size", "scheduler_config",
           "betas", "synthetic_grid", "unet_features")


@dataclasses.dataclass
class TrainConfig:
    # --- reference keys (train.py:148-208), defaults from launcher.sh ---
    model: str = "LSTM-64K5.32K3.16K3"
    species: str = "bcb"
    learning_rate: float = 1.0e-3
    dataset: str = "E33OMA90D"
    in_channels: int = 5
    hidden_channels: Tuple[int, ...] = (64, 32, 16)
    kernel_size: Tuple[int, ...] = (5, 3, 3)
    num_layers: int = 3
    sequence_length: int = 48
    transform: bool = False
    num_epochs: int = 30
    input_size: Tuple[int, int] = (100, 154)
    batch_size: int = 8
    num_workers: int = 1
    scheduler_config: Tuple[float, float] = (10, 0.9)
    betas: Tuple[float, float] = (0.5, 0.999)
    use_checkpoint: bool = False
    snapshot_dir: str = "./snapshots"
    restore_from: str = "./snapshots"
    # --- settings shared with the JAX package ---
    compute_dtype: str = "float32"  # or "bfloat16"
    precompute_input_conv: bool = False  # hoist layer 0's input conv
    seed: int = 0
    data_path: Optional[str] = None  # packed npz; None -> synthetic fixture
    synthetic_steps: int = 480  # fixture length when data_path is None
    synthetic_grid: Tuple[int, int] = (90, 144)  # fixture (lat, lon) size
    checkpoint_every: int = 10  # reference: every 10 epochs
    levels: int = 1  # vertical levels (20 for the 3-D fusion config)
    auto_resume: bool = False  # restart from the newest epoch-NNN checkpoint
    mode: str = "windowed"  # "windowed" | "seq2seq" (scheduled sampling, config #3)
    schedule_k: float = 10.0  # seq2seq teacher-forcing decay constant
    unet_features: Tuple[int, ...] = (64, 128, 256, 512)  # UNet encoder widths
    pix2pix_features: int = 64  # pix2pix Generator base width
    dp_devices: int = 1  # data-parallel ranks (parallel/dp.py)
    # --- the port's own ---
    device: str = "cuda"  # torch device the run trains on

    def __post_init__(self):
        if len(self.hidden_channels) != self.num_layers:
            raise ValueError(
                "The length of hidden_channels must be equal to num_layers."
            )
        if self.mode not in ("windowed", "seq2seq"):
            raise ValueError(f"mode must be windowed|seq2seq, got {self.mode!r}")
        # canonical channel counts: the 3-D fusion stack is C = 3*levels + 2,
        # seq2seq adds the feedback channel; explicit larger values (static
        # attribute channels) are kept
        base = 3 * self.levels + 2 if self.levels > 1 else 5
        if self.in_channels == 5 and base != 5:
            self.in_channels = base
        if self.mode == "seq2seq" and self.in_channels == base:
            self.in_channels = base + 1

    @property
    def family(self) -> str:
        from nasa_niswan_tpu_torch.models.registry import model_family

        return model_family(self.model)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in _TUPLES:
            d[k] = list(d[k])
        return d

    def dump(self, snapshot_dir: Optional[str] = None) -> str:
        """Write configurations.json (the training <-> evaluation contract)."""
        snapshot_dir = snapshot_dir or self.snapshot_dir
        os.makedirs(snapshot_dir, exist_ok=True)
        path = os.path.join(snapshot_dir, "configurations.json")
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=4)
        return path

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        """Read a configurations.json written by either package."""
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        for k in _TUPLES:
            if k in kwargs:
                kwargs[k] = tuple(kwargs[k])
        return cls(**kwargs)


def parse_args(argv=None) -> TrainConfig:
    """CLI mirroring the reference's flags plus the port's ``--device``."""
    import argparse

    d = TrainConfig.__dataclass_fields__
    p = argparse.ArgumentParser(
        description="Train a Smart NINT emulator with PyTorch on a CUDA device."
    )
    p.add_argument("--model", type=str, default=d["model"].default)
    p.add_argument("--species", type=str, default=d["species"].default)
    p.add_argument("--learning-rate", type=float, default=d["learning_rate"].default)
    p.add_argument("--dataset", type=str, default=d["dataset"].default)
    p.add_argument("--in-channels", type=int, default=d["in_channels"].default)
    p.add_argument("--hidden-channels", nargs="+", type=int, default=(64, 32, 16))
    p.add_argument("--kernel-size", nargs="+", type=int, default=(5, 3, 3))
    p.add_argument("--num-layers", type=int, default=d["num_layers"].default)
    p.add_argument("--sequence-length", type=int, default=d["sequence_length"].default)
    p.add_argument("--transform", action="store_true")
    p.add_argument("--num-epochs", type=int, default=d["num_epochs"].default)
    p.add_argument("--input-size", nargs=2, type=int, default=(100, 154))
    p.add_argument("--batch-size", type=int, default=d["batch_size"].default)
    p.add_argument("--num-workers", type=int, default=d["num_workers"].default)
    p.add_argument("--scheduler-config", nargs=2, type=float, default=(10, 0.9))
    p.add_argument("--betas", nargs=2, type=float, default=(0.5, 0.999))
    p.add_argument("--use-checkpoint", action="store_true")
    p.add_argument("--snapshot-dir", type=str, default=d["snapshot_dir"].default)
    p.add_argument("--restore-from", type=str, default=d["restore_from"].default)
    p.add_argument("--compute-dtype", type=str, default=d["compute_dtype"].default,
                   choices=("float32", "bfloat16"))
    p.add_argument("--precompute-input-conv", action="store_true")
    p.add_argument("--seed", type=int, default=d["seed"].default)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--synthetic-steps", type=int, default=d["synthetic_steps"].default)
    p.add_argument("--synthetic-grid", nargs=2, type=int, default=(90, 144))
    p.add_argument("--checkpoint-every", type=int, default=d["checkpoint_every"].default)
    p.add_argument("--levels", type=int, default=d["levels"].default)
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--mode", type=str, default=d["mode"].default,
                   choices=("windowed", "seq2seq"))
    p.add_argument("--schedule-k", type=float, default=d["schedule_k"].default)
    p.add_argument("--unet-features", nargs="+", type=int,
                   default=d["unet_features"].default)
    p.add_argument("--pix2pix-features", type=int,
                   default=d["pix2pix_features"].default)
    p.add_argument("--dp-devices", type=int, default=d["dp_devices"].default)
    p.add_argument("--device", type=str, default=d["device"].default)
    ns = p.parse_args(argv)
    kwargs = {k.replace("-", "_"): v for k, v in vars(ns).items()}
    for k in _TUPLES:
        kwargs[k] = tuple(kwargs[k])
    return TrainConfig(**kwargs)
