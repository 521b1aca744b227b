"""Device time per serving step of the PyTorch port with and without the
hoisted input conv, on one NVIDIA GPU.

The canonical C = 62 model (20-level fusion, hidden 64/32/16, kernels
5/3/3, 100x154 padded grid), random weights from seed 0, bf16, B = 1: one
48-step request through ``make_rollout_fn`` with ``precompute_input_conv``
False (every layer-0 step runs B1 over [x, h], Cin 126) and True (one
conv of all 48 frames by B3, then B1's xg mode over h alone, Cin 64).
Each run is one warm-up request, then ``--requests`` requests under
``torch.profiler``; the device time is the sum of the kernels' device time
over the steps.  The settings run in turns (off, on, on, off).  Prints the
card's name and power limit, a line per run, and one JSON line last.

    python scripts/time_hoist.py [--requests 2]
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

STEPS = 48


def device_ms_per_step(rollout, params, forcings, requests: int):
    """(device ms/step, wall ms/step) of ``requests`` chained requests."""
    rollout(params, forcings)  # warm-up (weights packed, allocator grown)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = None
        for _ in range(requests):
            _, state = rollout(params, forcings, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an op's CPU event also reports its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n = requests * STEPS
    return sum(e.self_device_time_total for e in events) / 1e3 / n, 1e3 * wall / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    C = 3 * 20 + 2
    cfg = ConvLSTMConfig(in_channels=C, hidden_channels=(64, 32, 16),
                         kernel_sizes=(5, 3, 3), compute_dtype="bfloat16")
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)
    forcings = torch.as_tensor(
        rng.standard_normal((1, STEPS, C, 90, 144), dtype=np.float32), device=device)
    norm = Normalizer(x_mean=np.zeros(C, np.float32), x_std=np.ones(C, np.float32),
                      y_mean=0.0, y_std=1.0)
    fns = {hoist: make_rollout_fn(cfg, norm, padded_shape=(100, 154), grid_shape=(90, 144),
                                  device=device, precompute_input_conv=hoist)
           for hoist in (False, True)}
    runs = {False: [], True: []}
    for hoist in (False, True, True, False):
        dev_ms, wall_ms = device_ms_per_step(fns[hoist], params, forcings, args.requests)
        runs[hoist].append({"device_ms": dev_ms, "wall_ms": wall_ms})
        print(f"precompute_input_conv={hoist}: device {dev_ms:.4f} ms/step, wall "
              f"{wall_ms:.4f} ms/step over {args.requests} x {STEPS} steps "
              f"(C={C}, B=1, bf16) on {smi}")
    mean = {h: float(np.mean([r["device_ms"] for r in rs])) for h, rs in runs.items()}
    print(json.dumps({"card": smi, "steps": args.requests * STEPS,
                      "unhoisted": runs[False], "hoisted": runs[True],
                      "device_ms_unhoisted": mean[False], "device_ms_hoisted": mean[True]}))


if __name__ == "__main__":
    main()
