"""Where the time of the PyTorch port's training steps goes, on one NVIDIA
GPU (the twin of scripts/profile_train_step.py).

Each route is a step on the kernel path at full width (hidden 64/32/16,
kernels 5/3/3, bf16, 100x154 padded, bs 8, T 48, Adam):

* ``remat``: the canonical windowed step (8 input channels) through
  ``make_device_train_step`` and the whole-scan BPTT;
* ``per-cell``: the same step with ``remat`` off (the per-cell Functions);
* ``hoist``: the same step with the hoisted input conv;
* ``seq2seq`` / ``seq2seq-remat``: config #3 (6 input channels, scheduled
  sampling with teacher_prob 0.5) through ``make_seq2seq_train_step``, on
  the per-cell route or the whole-chunk BPTT.

The windowed routes gather their batches from the device-resident frames
(``DeviceWindowSource``); config #3's batches are staged on the device
before the timing, so no route's time holds a host-to-device copy of its
batch (the JAX script's device-resident raw batch).

Per route of ``--routes`` (the JAX script's ``variants`` table): one
warm-up step, then ``--reps`` steps dispatched back to back and
synchronised once at the end: ``step_ms`` and ``days_per_min`` (B*T/48
model-days a step).  Then ``--route`` again under ``torch.profiler`` (CPU +
CUDA activity) for ``--steps`` steps: the wall time per step, the device
time per step and its busy share, the device time by kernel (top
``--top``), and scripts/torch_trace_summary.py's summary of the trace with
the training FLOPs of a step (the gate convs of B*T frames: the forward,
and the forward plus both gradients without the recompute).  Prints the
card's name and power limit first; ``--trace`` keeps the Chrome trace,
``--out`` writes the JSON.

    python scripts/profile_torch_train_step.py [--route remat] [--steps 2]
        [--routes remat per-cell hoist seq2seq seq2seq-remat] [--reps 6]
        [--top 15] [--trace train_trace.json] [--out OUT] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_trace_summary as ts  # noqa: E402
from torch_profile_rollout import sync  # noqa: E402

ROUTES = ("remat", "per-cell", "hoist", "seq2seq", "seq2seq-remat")
BS, SEQ = 8, 48
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
DATA_T = 720  # steps of the synthetic fixture
TEACHER_PROB = 0.5


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="remat", choices=ROUTES)
    ap.add_argument("--routes", nargs="*", default=list(ROUTES), choices=ROUTES)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    return ap.parse_args(argv)


def build_step(route: str, data, device):
    """``step(s)``: the s-th training step of ``route`` (it updates its own
    parameters in place)."""
    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset, SequenceDataset
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import (
        DeviceWindowSource,
        make_device_train_step,
        make_optimizer,
    )

    layers = dict(hidden_channels=HIDDEN, kernel_sizes=KERNELS, compute_dtype=DTYPE)
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    if route.startswith("seq2seq"):
        ds = Seq2SeqDataset(data, period="train", sequence_length=SEQ)
        cfg = ConvLSTMConfig(in_channels=6, remat=route == "seq2seq-remat", **layers)
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
        for t in param_leaves(params):
            t.requires_grad_(True)
        train_step = make_seq2seq_train_step(
            cfg, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)),
            external_draws=True, **geo)
        rng = np.random.default_rng(0)
        batches = []
        for b in range(2):  # staged on the device, used in turns
            items = [ds[(b * BS + i) % len(ds)] for i in range(BS)]
            batches.append([torch.as_tensor(np.stack(a), device=device) for a in zip(*items)])

        def step(s):
            train_step(params, *batches[s % 2], rng.random((SEQ, BS)) < TEACHER_PROB,
                       TEACHER_PROB)
        return step

    ds = SequenceDataset(data, period="train", sequence_length=SEQ, in_channels=8)
    bundle = build_model("LSTM-profile", in_channels=8, remat=route != "per-cell",
                         precompute_input_conv=route == "hoist", **layers)
    params, state = bundle.init(torch.Generator().manual_seed(0), device)
    src = DeviceWindowSource(ds, device)
    train_step = make_device_train_step(
        bundle, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)), src,
        static=data["static"][:3], **geo)
    order = np.random.default_rng(0).permutation(src.n)

    def step(s):
        s %= src.n // BS
        train_step(params, state, order[s * BS:(s + 1) * BS])
    return step


def step_table_row(step, reps: int, device) -> dict:
    """One warm-up step, then ``reps`` steps with one sync at the end."""
    step(0)
    sync(device)
    tic = time.perf_counter()
    for s in range(1, reps + 1):
        step(s)
    sync(device)
    sec = (time.perf_counter() - tic) / reps
    return {"step_ms": sec * 1e3, "days_per_min": (BS * SEQ / 48.0) / (sec / 60.0)}


def profile(step, route: str, args, device, card: str) -> dict:
    """``--steps`` steps of ``route`` under torch.profiler: wall and device
    time per step, the kernels by device time, the trace's summary."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(1, args.steps + 1):
            step(s)
        sync(device)
        wall = (time.perf_counter() - t0) / args.steps
    # kernels only: an op's CPU event also reports its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.steps
    print(f"route {route}: wall {1e3 * wall:.2f} ms/step, device {device_ms:.2f} ms/step "
          f"(busy {100 * device_ms / (1e3 * wall):.1f}%), over {args.steps} steps", flush=True)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[: args.top]:
        ms = e.self_device_time_total / 1e3 / args.steps
        print(f"{ms:10.3f} ms/step {100 * ms / device_ms:5.1f}%  "
              f"{e.count // args.steps:6d} calls  {e.key[:90]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)
        config = "closedloop6" if route.startswith("seq2seq") else "train8"
        fwd, fwd_bwd = ts.train_gflops_per_step(config, BS, SEQ, PADDED[1])
        summary = ts.summarize_file(path, steps=args.steps, label=route, config=config,
                                    width=PADDED[1], batch=BS, gflops_per_step=fwd_bwd,
                                    card=card)
    dev_step = summary["device_ms_per_step"]
    summary["forward_gflops_per_step"] = fwd
    summary["forward_tflops"] = fwd / dev_step if dev_step > 0 else None
    print(json.dumps(summary), flush=True)
    return {"route": route, "wall_ms": 1e3 * wall, "device_ms": device_ms,
            "summary": summary}


def main(argv=None):
    args = _parse(argv)
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    card = ts.card(device)
    print(card, flush=True)
    data = synthetic_e33oma_90d(T=DATA_T, H=GRID[0], W=GRID[1], seed=0)
    out = {"config": f"bs {BS}, T={SEQ}, {PADDED[0]}x{PADDED[1]}, {DTYPE}", "card": card}
    routes = list(dict.fromkeys([*args.routes, args.route]))
    for route in routes:
        step = build_step(route, data, device)
        if route in args.routes:
            out[route] = step_table_row(step, args.reps, device)
            print(json.dumps({route: out[route]}), flush=True)
        if route == args.route:
            out["profile"] = profile(step, route, args, device, card)
        del step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ts.write_json(out, args.out)
    print(json.dumps({k: v for k, v in out.items() if k != "profile"}), flush=True)
    return out


if __name__ == "__main__":
    main()
