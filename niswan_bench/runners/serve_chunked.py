"""Chained serving: the open-loop rollout in chunks chained through the carry.

Each chunk is one call of ``rollout.autoregressive.make_rollout_fn``'s
rollout, on a card one ``GraphRunner`` replay, over device-resident raw
forcings (``blocks`` seeded chunks, taken in turn).  The first
``warm_chunks`` chunks of the chain (the capture, then replays) and
``settle_chunks`` more are set-up; the window continues the chain.

The check: the reference chains the warm-up chunks itself from a zero
carry, and follows the port from its own carry over one window chunk drawn
from the seed among the first ``sample_within`` and over the window's last
chunk.  Each chunk compares every frame's prediction and the carry handed
on.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
from niswan_bench.lib import clock, compare, data, loop, port
from niswan_bench.reference.convlstm import Model, to_nchw, to_nhwc


class PortChunks:
    """The system under test: one rollout call per chunk."""

    def __init__(self, config, stats, params, device):
        self.params = params
        self.rollout = make_rollout_fn(
            port.convlstm_config(config), port.normalizer(stats),
            padded_shape=tuple(config["padded"]), grid_shape=tuple(config["grid"]),
            device=device)

    def __call__(self, forcings, state):
        return self.rollout(self.params, forcings, state)


class ControlChunks:
    """The reference at fp8 operands in the port's place (NHWC carries)."""

    def __init__(self, config, stats, params, device):
        self.model = Model(params, config, stats, precision="fp8")

    def __call__(self, forcings, state):
        nchw = None if state is None else [(to_nchw(h), to_nchw(c)) for h, c in state]
        preds, new = self.model.rollout(forcings, nchw)
        return preds, [(to_nhwc(h), to_nhwc(c)) for h, c in new]


SYSTEMS = {"port": PortChunks, "control": ControlChunks}


class Runner:
    def __init__(self, config, traffic, seed, device, system="port"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.system_name = system

    def setup(self):
        cfg, tr = self.config, self.traffic
        self.phases = clock.Phases()
        gen = data.generator(self.seed, self.device)
        self.params = data.convlstm_params(gen, cfg, self.device)
        self.stats = data.normalizer_stats(gen, cfg["in_channels"])
        shape = (tr["batch"], tr["chunk_steps"], cfg["in_channels"], *cfg["grid"])
        self.blocks = [data.frames(gen, shape, self.stats) for _ in range(tr["blocks"])]
        loop.sync(self.device)
        self.phases.mark("inputs")
        self.system = SYSTEMS[self.system_name](cfg, self.stats, self.params, self.device)
        self.draw = int(np.random.default_rng(self.seed).integers(tr["sample_within"]))
        self.state, self.index, self.kept, self.last = None, 0, {}, None
        self.window_start = None
        for _ in range(tr["warm_chunks"]):
            self._chunk(keep=True)
        for _ in range(tr["settle_chunks"]):  # until the allocator holds what a chunk takes
            self._chunk()
        loop.sync(self.device)
        self.phases.mark("warm-up")

    def _chunk(self, keep=False):
        i = self.index
        state_in = self.state
        preds, state_out = self.system(self.blocks[i % len(self.blocks)], state_in)
        if keep:
            self.kept[i] = (i, state_in, preds, state_out)
        self.last = (i, state_in, preds, state_out)
        self.state = state_out
        self.index += 1

    def run(self, seconds=None, count=None, measured=True):
        if measured:
            self.window_start = self.index

        def unit(_):
            keep = measured and self.index - self.window_start == self.draw
            self._chunk(keep=keep)

        n, wall = loop.closed_loop(unit, self.device, seconds=seconds, count=count)
        if measured:
            self.final = self.last
        return {"units": n, "wall_s": wall, "frames": n * self.traffic["chunk_steps"],
                "batch": self.traffic["batch"]}

    def e2e(self, window):
        days = window["frames"] * window["batch"] * self.config["species"] \
            / self.config["steps_per_day"]
        return {"serve_days_per_min": days / (window["wall_s"] / 60.0)}

    def release(self):
        self.system = None
        self.last = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        ref = Model(self.params, self.config, self.stats)
        pred_gaps, carry_gaps = [], []

        def compare_chunk(i, state_ref_in, preds_p, out_p):
            preds_r, out_r = ref.rollout(self.blocks[i % len(self.blocks)], state_ref_in)
            pred_gaps.append(compare.frame_rms_max(preds_p, preds_r))
            carry_gaps.append(compare.carry_rms_max(
                [t for hc in out_p for t in hc],
                [to_nhwc(t) for hc in out_r for t in hc]))
            return out_r

        chained = None  # the reference's own chain from a zero carry
        for i in range(self.traffic["warm_chunks"]):
            _, _, preds_p, out_p = self.kept[i]
            chained = compare_chunk(i, chained, preds_p, out_p)
        drawn = self.window_start + self.draw
        if drawn not in self.kept:
            raise RuntimeError("the window ended before the drawn chunk; lengthen the "
                               "window or lower sample_within")
        entries = [self.kept[drawn]] + ([self.final] if self.final[0] != drawn else [])
        for i, in_p, preds_p, out_p in entries:  # followed from the port's carry
            compare_chunk(i, [(to_nchw(h), to_nchw(c)) for h, c in in_p], preds_p, out_p)
        return {"pred_frame_rms": max(pred_gaps), "carry_rms": max(carry_gaps)}, len(pred_gaps)
