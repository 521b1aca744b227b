"""Where the time of the PyTorch port's training steps goes, on one NVIDIA
GPU.

``--route`` picks the step, all on the kernel path at full width (hidden
64/32/16, kernels 5/3/3, bf16, 100x154 padded, bs 8, T 48, Adam):

* ``remat`` (default): the canonical windowed step (8 input channels)
  through ``make_device_train_step`` and the whole-scan BPTT;
* ``per-cell``: the same step with ``remat`` off (the per-cell Functions);
* ``hoist``: the same step with the hoisted input conv;
* ``seq2seq`` / ``seq2seq-remat``: config #3 (6 input channels, scheduled
  sampling with teacher_prob 0.5) through ``make_seq2seq_train_step``, on
  the per-cell route or the whole-chunk BPTT.

One warm-up step, then ``--steps`` steps under ``torch.profiler`` (CPU +
CUDA activity).  Prints the card's name and power limit, the wall time per
step, the device time per step and its busy share, and the device time by
kernel (top ``--top``).

    python scripts/profile_torch_train_step.py [--route remat] [--steps 2]
        [--top 15] [--trace train_trace.json]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="remat",
                    choices=("remat", "per-cell", "hoist", "seq2seq", "seq2seq-remat"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset, SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import (
        DeviceWindowSource,
        make_device_train_step,
        make_optimizer,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    device = torch.device("cuda", 0)
    bs, T = 8, 48
    layers = dict(hidden_channels=(64, 32, 16), kernel_sizes=(5, 3, 3),
                  compute_dtype="bfloat16")
    geo = dict(padded_shape=(100, 154), grid_shape=(90, 144))
    data = synthetic_e33oma_90d(T=720, H=90, W=144, seed=0)
    if args.route.startswith("seq2seq"):
        ds = Seq2SeqDataset(data, period="train", sequence_length=T)
        cfg = ConvLSTMConfig(in_channels=6, remat=args.route == "seq2seq-remat", **layers)
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
        for t in param_leaves(params):
            t.requires_grad_(True)
        train_step = make_seq2seq_train_step(
            cfg, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)),
            external_draws=True, **geo)
        rng = np.random.default_rng(0)

        def step(s):
            items = [ds[(s + i) % len(ds)] for i in range(bs)]
            x, p0, y = (torch.as_tensor(np.stack(a), device=device) for a in zip(*items))
            train_step(params, x, p0, y, rng.random((T, bs)) < 0.5, 0.5)
    else:
        ds = SequenceDataset(data, period="train", sequence_length=T, in_channels=8)
        bundle = build_model("LSTM-profile", in_channels=8, remat=args.route != "per-cell",
                             precompute_input_conv=args.route == "hoist", **layers)
        params, state = bundle.init(torch.Generator().manual_seed(0), device)
        src = DeviceWindowSource(ds, device)
        train_step = make_device_train_step(
            bundle, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)), src,
            static=data["static"][:3], **geo)
        order = np.random.default_rng(0).permutation(src.n)

        def step(s):
            train_step(params, state, order[s * bs : (s + 1) * bs])

    step(0)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(1, args.steps + 1):
            step(s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    # kernels only: an op's CPU event also reports its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.steps
    print(f"route {args.route}: wall {1e3 * wall:.2f} ms/step, device {device_ms:.2f} ms/step "
          f"(busy {100 * device_ms / (1e3 * wall):.1f}%), over {args.steps} steps")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[: args.top]:
        ms = e.self_device_time_total / 1e3 / args.steps
        print(f"{ms:10.3f} ms/step {100 * ms / device_ms:5.1f}%  "
              f"{e.count // args.steps:6d} calls  {e.key[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
