"""Training from a device-resident slab: the route ``train/loop.fit`` takes
when the split fits in half the card.

The raw frames of one training year and their targets are made on the
device; each step's windows are gathered there by ``DeviceWindowSource``
from (B,) window starts in ``batch_iterator``'s shuffled order, and the
step (preprocessing, the whole-scan BPTT route, MSE + L1, Adam) is one
``StepGraph`` replay (``make_device_train_step``).  The first three steps
are set-up and checked (lib/training.py).
"""

from __future__ import annotations

import torch

from nasa_niswan_tpu_torch.data.pipeline import batch_indices, shard_indices
from nasa_niswan_tpu_torch.train.loop import DeviceWindowSource, make_device_train_step
from niswan_bench.lib import data, port
from niswan_bench.lib.training import CHECKED_STEPS, TrainRunner
from niswan_bench.reference.feed import batch_order, order_seed


class SlabSource(DeviceWindowSource):
    """``DeviceWindowSource`` over a slab that is already on the device (its
    constructor uploads a dataset's host slab)."""

    def __init__(self, frames: torch.Tensor, targets: torch.Tensor, seq_len: int):
        self.seq_len = seq_len
        self.n = len(targets)
        self.device = frames.device
        self.frames = frames
        self.targets = targets
        self._offsets = torch.arange(seq_len, device=self.device)


class Runner(TrainRunner):
    def make_data(self, gen):
        cfg, tr = self.config, self.traffic
        seq = cfg["sequence_length"]
        self.frames = data.frames(gen, (tr["slab_frames"], cfg["dynamic_channels"],
                                        *cfg["grid"]), self.stats)
        self.targets = data.targets(gen, tr["slab_frames"] - seq + 1, cfg["grid"], self.stats)
        self.offsets = torch.arange(seq, device=self.device)

    def make_port(self, model, optimizer):
        cfg = self.config
        return make_device_train_step(
            model, port.normalizer(self.stats), optimizer,
            SlabSource(self.frames, self.targets, cfg["sequence_length"]),
            padded_shape=tuple(cfg["padded"]), grid_shape=tuple(cfg["grid"]),
            static=self.static)

    def feed(self, epoch):
        bs = self.config["batch_size"]
        return ((torch.as_tensor(shard_indices(idx, bs, 0, 1)),)
                for idx in batch_indices(len(self.targets), bs, seed=order_seed(self.seed),
                                         epoch=epoch))

    def gather(self, starts):
        starts = starts.to(self.device)
        return self.frames[starts[:, None] + self.offsets], self.targets[starts]

    def reference_batches(self):
        for idx in batch_order(len(self.targets), self.config["batch_size"], self.seed,
                               1)[:CHECKED_STEPS]:
            starts = torch.as_tensor(idx, device=self.device)
            yield self.frames[starts[:, None] + self.offsets], self.targets[starts]
