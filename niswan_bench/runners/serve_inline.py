"""In-line serving: one caller steps the emulator frame by frame, as a host
model couples it, with no think time.

Each call is ``rollout.autoregressive.make_streaming_rollout``'s
``step(frame)`` on one raw (B, C, H, W) f32 frame in pinned host memory
(as a coupler that registers its exchange buffers holds it), taken in turn
from a seeded pool of ``pool_frames``; the prediction is read
back to host memory before the next call.  A call's latency runs from the
call to the prediction in host memory.  The carry lives in the step's graph
buffers; the first ``warm_calls`` calls (the capture among them) are
set-up, and the window continues the same chain.

The check: the reference runs the first ``first_calls`` calls of the chain
itself from a zero carry, and follows the port from its carry over
``late_calls`` calls from a call drawn from the seed among the next
``late_within``; both compare every prediction and the carry after them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from nasa_niswan_tpu_torch.rollout.autoregressive import make_streaming_rollout
from niswan_bench.lib import clock, compare, data, loop, port
from niswan_bench.reference.convlstm import Model, to_nchw, to_nhwc


class PortInline:
    """The system under test: the streaming step and its carry."""

    def __init__(self, config, stats, params, device):
        self.step = make_streaming_rollout(
            port.convlstm_config(config), port.normalizer(stats), params,
            padded_shape=tuple(config["padded"]), grid_shape=tuple(config["grid"]),
            device=device)

    def __call__(self, frame) -> torch.Tensor:
        return self.step(frame).cpu()

    def carry(self):
        return [t.clone() for hc in self.step.carry() for t in hc]


class ControlInline:
    """The reference at fp8 operands in the port's place."""

    def __init__(self, config, stats, params, device):
        self.model = Model(params, config, stats, precision="fp8")
        self.device = torch.device(device)
        self.state = None

    def __call__(self, frame) -> torch.Tensor:
        x = torch.as_tensor(frame, device=self.device)[:, None]
        preds, self.state = self.model.rollout(x, self.state)
        return preds[:, 0].cpu()

    def carry(self):
        return [to_nhwc(t) for hc in self.state for t in hc]


SYSTEMS = {"port": PortInline, "control": ControlInline}


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
        pool = data.frames(gen, (tr["pool_frames"], tr["batch"], cfg["in_channels"],
                                 *cfg["grid"]), self.stats)
        self.pool = pool.cpu()
        if self.device.type == "cuda":
            self.pool = self.pool.pin_memory()
        del pool
        self.phases.mark("inputs")
        self.system = SYSTEMS[self.system_name](cfg, self.stats, self.params, self.device)
        offset = int(np.random.default_rng(self.seed).integers(tr["late_within"]))
        self.late = (tr["first_calls"] + offset, tr["first_calls"] + offset + tr["late_calls"])
        self.calls, self.kept, self.snaps, self.latencies = 0, {}, {}, []
        for _ in range(tr["warm_calls"]):
            self._call()
        loop.sync(self.device)
        self.phases.mark("warm-up")

    def _call(self):
        i = self.calls
        if i == self.late[0]:
            self.snaps["late_in"] = self.system.carry()
        frame = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        out = self.system(frame)
        self.latencies.append(time.perf_counter() - t0)
        if i < self.traffic["first_calls"] or self.late[0] <= i < self.late[1]:
            self.kept[i] = out
        if i == self.traffic["first_calls"] - 1:
            self.snaps["first_out"] = self.system.carry()
        if i == self.late[1] - 1:
            self.snaps["late_out"] = self.system.carry()
        self.calls += 1

    def run(self, seconds=None, count=None, measured=True):
        self.latencies = []
        n, wall = loop.closed_loop(lambda _: self._call(), self.device,
                                   seconds=seconds, count=count)
        return {"units": n, "wall_s": wall, "latencies_s": list(self.latencies)}

    def e2e(self, window):
        return {"inline_step_ms_mean": 1e3 * window["wall_s"] / window["units"]}

    def release(self):
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        tr = self.traffic
        if self.calls < self.late[1]:
            raise RuntimeError("the window ended before the drawn calls; lengthen the "
                               "window or lower late_within")
        ref = Model(self.params, self.config, self.stats)
        pool = torch.as_tensor(self.pool, device=self.device)  # (P, B, C, H, W)
        pred_gaps, carry_gaps = [], []

        def segment(lo, hi, state_in, carry_out):
            idx = torch.arange(lo, hi) % len(self.pool)
            x = pool[idx].transpose(0, 1)  # (B, T, C, H, W)
            preds_r, out_r = ref.rollout(x, state_in)
            preds_p = torch.stack([self.kept[i] for i in range(lo, hi)], dim=1)
            pred_gaps.append(compare.frame_rms_max(preds_p, preds_r))
            carry_gaps.append(compare.carry_rms_max(carry_out, [to_nhwc(t) for hc in out_r
                                                                for t in hc]))

        segment(0, tr["first_calls"], None, self.snaps["first_out"])
        late_in = self.snaps["late_in"]
        segment(*self.late, [(to_nchw(late_in[i]), to_nchw(late_in[i + 1]))
                             for i in range(0, len(late_in), 2)], self.snaps["late_out"])
        return ({"pred_frame_rms": max(pred_gaps), "carry_rms": max(carry_gaps)},
                tr["first_calls"] + tr["late_calls"])
