#!/usr/bin/env python3
"""Profile the seq2seq scheduled-sampling train step (config #3) on the
port, the twin of scripts/profile_seq2seq.py.

    python scripts/torch_profile_seq2seq.py [--T 48] [--batch 4] [--reps 3]
        [--device cuda]

Times ``rollout/seq2seq.make_seq2seq_train_step`` (one Adam step, teacher
probability 0.8, the draws from a generator on the device) at the
canonical 6-channel surface shapes (ConvLSTM 64/32/16, kernels 5/3/3, bf16,
90 x 144 padded to 100 x 154), random weights from seed 0, inputs resident
on the device, on both routes:

* ``baseline``: the per-cell route (``remat`` off; B1's emit_gates, then B3
  and B2's dW kernels).  It takes the place of the JAX script's
  ``baseline_xla`` (XLA cells under remat), which is TPU-only;
* ``fused_bptt``: the whole-chunk BPTT (``remat``; B1, then B2 and B3),
  with ``speedup_vs_per_cell`` (the JAX script's ``speedup_vs_xla``).

Each timing: one warm-up step, then the mean of ``--reps`` steps, each
synchronised on its loss.  The feedback-pad ablation times both routes
with ``ops/seq2seq_bptt.fb_channel``, through which every step's feedback
frame is built (forward and backward), swapped for a zero pad of the same
shape (``zero_pad_feedback``; restored afterwards, also when a step
raises).  The numbers differ at the margins: a timing ablation only.  Each
of the four (route, pad) settings is timed twice, in turns (geo, zero,
zero, geo on each route), and its two timings averaged: ``pad_share`` is
the share of the step the geophysical pad costs, on each route.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_trace_summary as ts  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.ops import seq2seq_bptt  # noqa: E402
from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import make_optimizer  # noqa: E402

MET = 5
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
TEACHER_PROB = 0.8


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    return ap.parse_args(argv)


def zero_fb_channel(fb: torch.Tensor, padded_shape) -> torch.Tensor:
    """``fb_channel``'s stand-in: (B, h, w) -> (B, H, W, 1), the map in the
    top-left corner and zeros elsewhere (the JAX ablation's pad)."""
    h, w = fb.shape[-2:]
    return F.pad(fb, (0, padded_shape[1] - w, 0, padded_shape[0] - h))[..., None]


@contextlib.contextmanager
def zero_pad_feedback():
    """Within the block every feedback frame is built by ``zero_fb_channel``."""
    real = seq2seq_bptt.fb_channel
    seq2seq_bptt.fb_channel = zero_fb_channel
    try:
        yield
    finally:
        seq2seq_bptt.fb_channel = real


def main(argv=None):
    args = _parse(argv)
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    card = ts.card(device)
    print(card, flush=True)
    B, T = args.batch, args.T
    cfg = ConvLSTMConfig(in_channels=MET + 1, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype=DTYPE)
    norm = Normalizer(x_mean=np.zeros(MET, np.float32), x_std=np.ones(MET, np.float32),
                      y_mean=0.0, y_std=1.0)
    r = np.random.default_rng(0)
    x, p0, y = (torch.as_tensor(r.standard_normal(s).astype(np.float32), device=device)
                for s in ((B, T, MET, *GRID), (B, *GRID), (B, T, *GRID)))

    def timed(remat: bool) -> float:
        """Seconds per step of the route, from fresh weights and Adam state."""
        c = dataclasses.replace(cfg, remat=remat)
        params = convlstm_init(torch.Generator().manual_seed(0), c, device=device)
        for t in param_leaves(params):
            t.requires_grad_(True)
        step = make_seq2seq_train_step(c, norm, make_optimizer(params, 1e-3, (0.5, 0.999)),
                                       padded_shape=PADDED, grid_shape=GRID)
        gen = torch.Generator(device=device).manual_seed(1)
        float(step(params, x, p0, y, gen, TEACHER_PROB)["loss"])
        tic = time.perf_counter()
        for _ in range(args.reps):
            float(step(params, x, p0, y, gen, TEACHER_PROB)["loss"])
        return (time.perf_counter() - tic) / args.reps

    # (remat, zero pad) in turns: geo, zero, zero, geo on each route
    order = [(False, False), (True, False), (False, True), (True, True),
             (True, True), (False, True), (True, False), (False, False)]
    secs = {key: [] for key in order}
    for remat, zero in order:
        with zero_pad_feedback() if zero else contextlib.nullcontext():
            secs[remat, zero].append(timed(remat))
    step_s, step_fused_s, nopad_s, fused_nopad_s = (
        sum(secs[key]) / 2 for key in ((False, False), (True, False), (False, True),
                                       (True, True)))
    print(json.dumps({"baseline": step_s}), flush=True)
    print(json.dumps({"fused_bptt": step_fused_s,
                      "speedup_vs_per_cell": step_s / step_fused_s}), flush=True)
    result = {
        "B": B, "T": T, "step_s": step_s,
        "step_fused_s": step_fused_s,
        "speedup_vs_per_cell": step_s / step_fused_s,
        "step_zero_pad_s": nopad_s,
        "step_fused_zero_pad_s": fused_nopad_s,
        "pad_share": 1 - nopad_s / step_s,
        "pad_share_fused": 1 - fused_nopad_s / step_fused_s,
        "ms_per_scan_step": step_s / T * 1e3,
        "ms_per_scan_step_fused": step_fused_s / T * 1e3,
        "runs_s": {f"{'remat' if remat else 'per_cell'}_{'zero' if zero else 'geo'}_pad": v
                   for (remat, zero), v in secs.items()},
        "card": card,
    }
    print(json.dumps(result), flush=True)
    ts.write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
