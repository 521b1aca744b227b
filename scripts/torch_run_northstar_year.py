#!/usr/bin/env python3
"""The north-star rollout sustained for a model year on the port, the twin
of scripts/run_northstar_year.py.

    python scripts/torch_run_northstar_year.py [--block 1440] [--steps 17520]
        [--chunk 480] [--out DIR] [--device cuda]

bench.py's serving configuration (C = 62, the 20-level fusion; ConvLSTM
64/32/16, kernels 5/3/3; bf16; B = 1; padded 100 x 154) driven through
``--steps`` half-hour steps (17,520: one model year) with one carried
state.  A ``--block``-step f32 forcing block (1440 steps: 4.63 GB at
C = 62) is drawn from ``default_rng(0)`` as the JAX script draws it, uploaded
once and cycled in chunks of ``--chunk`` steps; each chunk is one CUDA
graph replay on a card (``make_rollout_fn``).  A graph reads its inputs
from buffers of its own, so each chunk is first copied there from the
block: that copy's device time is measured beside the chunk's.

The carry's health, the RMS of layer 1's h, is computed on the device once
a month (every MONTH steps) and fetched once after the year.  The port has
no column margin, so there is nothing to crop from h.  Writes
``<out>/results_northstar_year.json``: the JAX script's keys, plus the
device, the B1 launches of the year loop and the chunk copy's time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

C = 62
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
MONTH = 1440  # steps between two readings of the carry's RMS (30 days)
DRAW_FRAMES = 48  # frames drawn on the host and uploaded at a time


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=17520)
    ap.add_argument("--block", type=int, default=1440)
    ap.add_argument("--chunk", type=int, default=480)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "northstar_year_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    # every chunk is a whole --chunk: the block is cycled in whole chunks
    if args.block % args.chunk or args.steps % args.chunk:
        ap.error("--block and --steps must be multiples of --chunk")
    return args


def forcing_block(n_steps: int, device, seed: int = 0):
    """(1, n_steps, C, *GRID) f32 on ``device``: the values of
    ``default_rng(seed).standard_normal((1, n_steps, C, *GRID))`` cast to
    f32 (the JAX script's block), drawn and uploaded DRAW_FRAMES frames at
    a time so the host never holds the whole block in f64."""
    import torch

    rng = np.random.default_rng(seed)
    block = torch.empty((1, n_steps, C, *GRID), dtype=torch.float32, device=device)
    for s in range(0, n_steps, DRAW_FRAMES):
        m = min(DRAW_FRAMES, n_steps - s)
        frames = rng.standard_normal((m, C, *GRID)).astype(np.float32)
        block[0, s:s + m].copy_(torch.from_numpy(frames))
    return block


def year_loop(rollout, params, block, steps: int, chunk: int) -> dict:
    """Serve ``steps`` steps from ``block`` (cycled) in chunks of ``chunk``
    with one carried state.  Returns the last chunk's predictions, the
    layer-1 h RMS read once a month (device scalars stacked and fetched
    once, after the loop), the loop's seconds (host clock, synchronised at
    the end) and the B1 plain launches it made."""
    import torch

    from nasa_niswan_tpu_torch.ops import convlstm_cell

    n_block = block.shape[1]
    state, monthly, done = None, [], 0
    launches0 = convlstm_cell.launches
    t0 = time.perf_counter()
    with torch.inference_mode():
        while done < steps:
            s = done % n_block
            p, state = rollout(params, block[:, s:s + chunk], state)
            done += chunk
            if done % MONTH < chunk:  # once a month, on the device
                h1 = state[0][0]
                monthly.append(torch.sqrt(torch.mean(h1 * h1)))
        last = p.cpu()  # the final sync
    elapsed = time.perf_counter() - t0
    rms = torch.stack(monthly).cpu().tolist() if monthly else []
    return {"preds": last, "monthly_h1_rms": rms, "steps": done, "elapsed": elapsed,
            "launches": convlstm_cell.launches - launches0}


def copy_in_ms(block, chunk: int, reps: int = 10):
    """Device ms of copying one chunk of the block into another buffer, as
    the graph's input copy does (CUDA events, after a warm-up); None off
    the card."""
    import torch

    if not block.is_cuda:
        return None
    buf = torch.empty_like(block[:, :chunk])
    buf.copy_(block[:, :chunk])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for r in range(reps):
        s = (r * chunk) % block.shape[1]
        buf.copy_(block[:, s:s + chunk])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    args = _parse(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.autoregressive import (
        make_rollout_fn,
        model_days_per_min,
    )
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    cfg = ConvLSTMConfig(in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype=DTYPE)
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    norm = Normalizer(x_mean=np.zeros(C, np.float32), x_std=np.ones(C, np.float32),
                      y_mean=0.0, y_std=1.0)
    rollout = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID)

    t0 = time.time()
    block = forcing_block(args.block, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    up_s = time.time() - t0
    up_mb = block.numel() * 4 / 1e6
    print(f"resident forcing block uploaded: {up_s:.1f}s "
          f"({up_mb / up_s:.0f} MB/s host->device incl. host RNG)", flush=True)

    # warm-up: the chunk's graph is captured here, outside the timed year
    with torch.inference_mode():
        p, _ = rollout(params, block[:, :args.chunk])
        p.cpu()

    year = year_loop(rollout, params, block, args.steps, args.chunk)
    copy_ms = copy_in_ms(block, args.chunk)
    chunk_ms = 1000 * year["elapsed"] * args.chunk / year["steps"]
    result = {
        "config": "north-star 90x144x20 rollout sustained one model year, "
                  "B=1, bf16, carried state",
        "steps": int(year["steps"]),
        "serving_wall_s": year["elapsed"],
        "model_days_per_min": model_days_per_min(year["steps"], year["elapsed"]),
        "monthly_h1_rms": year["monthly_h1_rms"],
        "device": name,
        "block": args.block,
        "chunk": args.chunk,
        "b1_plain_launches": year["launches"],
        "chunk_ms": chunk_ms,
        "chunk_copy_in_ms": copy_ms,
    }
    print(json.dumps(result, indent=2), flush=True)
    with open(os.path.join(args.out, "results_northstar_year.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
