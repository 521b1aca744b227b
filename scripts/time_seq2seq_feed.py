"""How the way config #3's batches reach the card changes its training step,
on one NVIDIA GPU.

The seq2seq training step (``make_seq2seq_train_step``: in_channels 6,
hidden 64/32/16, kernels 5/3/3, bf16, 100x154 padded, bs 8, T 48, teacher
probability 0.5) over one epoch of ``--steps`` batches of
``synthetic_e33oma_90d(T=720, 90x144)`` repeated, on ``--route`` (per-cell
or the whole-chunk BPTT), with the batches fed four ways, in turns:

* ``staged``: every batch copied to the card before the epoch;
* ``async``: ``data/pipeline.async_batches`` (a producer thread stacks each
  batch in pinned memory and copies it on a side stream), as
  ``fit_seq2seq`` takes them;
* ``prefetch``: ``device_prefetch`` over ``batch_iterator`` (pinned memory
  and a side stream, no thread: each batch is stacked between steps);
* ``sync``: ``batch_iterator``'s numpy batches moved by the step itself
  (pageable copies), the loop ``fit_seq2seq`` ran before it streamed.

Prints the card's name and power limit, the wall time per step of each feed
(after a warm-up epoch, two runs of each in turns) and the share of it spent
waiting for the next batch (``host_input_wait_frac``, as bench.py's
main_train defines it), then for ``staged`` and ``async`` the device time
per step and the device's busy share under ``torch.profiler``, and one JSON
line last.

    python scripts/time_seq2seq_feed.py [--route bptt] [--steps 7]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="bptt", choices=("bptt", "per-cell"))
    ap.add_argument("--steps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset
    from nasa_niswan_tpu_torch.data.pipeline import async_batches, batch_iterator, device_prefetch
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    bs, T = 8, 48
    data = synthetic_e33oma_90d(T=720, H=90, W=144, seed=0)
    base = Seq2SeqDataset(data, period="train", sequence_length=T)
    reps = 1  # repeat the fixture until an epoch holds --steps batches
    while True:
        ds = Seq2SeqDataset((np.concatenate([base._xs] * reps),
                             np.concatenate([base._y] * reps)),
                            period="train", sequence_length=T)
        if len(ds) >= args.steps * bs:
            break
        reps += 1
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=(64, 32, 16), kernel_sizes=(5, 3, 3),
                         compute_dtype="bfloat16", remat=args.route == "bptt")
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    for t in param_leaves(params):
        t.requires_grad_(True)
    step = make_seq2seq_train_step(cfg, base.normalizer,
                                   make_optimizer(params, 1e-3, (0.5, 0.999)),
                                   padded_shape=(100, 154), grid_shape=(90, 144))
    gen = torch.Generator().manual_seed(0)

    def epoch_batches(feed, epoch):
        it = batch_iterator(ds, bs, seed=0, epoch=epoch)
        if feed == "async":
            it = async_batches(ds, bs, seed=0, epoch=epoch, device=device)
        elif feed == "prefetch":
            it = device_prefetch(it, size=2, device=device)
        elif feed == "staged":
            it = iter([tuple(torch.as_tensor(a, device=device) for a in b) for b in it])
        n = 0
        for batch in it:
            if n == args.steps:
                break
            n += 1
            yield batch

    waits = {}

    def run(feed, epoch):
        """ms/step; the share of the loop spent waiting for the next batch
        (bench.py main_train's host_input_wait_frac) goes to ``waits``."""
        batches = epoch_batches(feed, epoch)
        if feed == "staged":
            batches = iter(list(batches))  # staged before the clock starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, wait = 0, 0.0
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - tw
            if batch is None:
                break
            step(params, *batch, gen, 0.5)
            n += 1
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        waits.setdefault(feed, []).append(wait / elapsed)
        return 1000 * elapsed / n

    feeds = ("staged", "async", "prefetch", "sync")
    for feed in feeds:
        run(feed, 0)  # warm-up
    waits.clear()
    wall = {f: [] for f in feeds}
    for feed in feeds + feeds[::-1]:
        wall[feed].append(run(feed, 1))
    for feed in feeds:
        print(f"route {args.route}, feed {feed}: {wall[feed]} ms/step, host_input_wait_frac "
              f"{waits[feed]} over {args.steps} steps (bs {bs}, T {T}, C=6, bf16) on {smi}")

    device_ms = {}
    for feed in ("staged", "async"):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ms = run(feed, 2)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.steps
        device_ms[feed] = {"wall_ms": ms, "device_ms": kernel_ms, "busy": kernel_ms / ms}
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
        print(f"route {args.route}, feed {feed} under the profiler: wall {ms:.1f} ms/step, "
              f"device {kernel_ms:.1f} ms/step (busy {100 * kernel_ms / ms:.1f}%); top: " +
              "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / args.steps:.2f}"
                        for e in top))
    print(json.dumps({"card": smi, "route": args.route, "steps": args.steps, "wall_ms": wall,
                      "host_input_wait_frac": {f: waits[f][:2] for f in feeds},
                      "profiled": device_ms}))


if __name__ == "__main__":
    main()
