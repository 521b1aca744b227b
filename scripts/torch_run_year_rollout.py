#!/usr/bin/env python3
"""The year-horizon closed-loop demonstration on the port, the twin of
scripts/run_year_rollout.py.

    python scripts/torch_run_year_rollout.py [--train-days 30] [--epochs 12]
        [--steps 17520] [--chunk 1752] [--out DIR] [--device cuda]

Trains the canonical surface emulator (8 inputs: 5 forcings + 3 static
channels; ConvLSTM 64/32/16, kernels 5/3/3, bf16, the remat route) with
the port's ``fit`` on the first ``--train-days`` days of a year-long
synthetic realization (seed 7), then serves the rest of the year (16,080
half-hour steps at the defaults) through the state-carrying rollout in
chunks of ``--chunk`` steps, each one CUDA graph replay on a card, fetched
one chunk behind the dispatch (``data/pipeline.ChunkDrain``).  Skill as a
function of horizon: the per-step temporal R^2 (``evalx.metrics.r2_temporal``)
averaged over each 30-day block (BLOCK steps).  Writes
``<out>/results_year.json``: the JAX script's keys.
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

HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
SEQ = 48  # training window (one day)
BATCH = 8
DTYPE = "bfloat16"
STEPS_PER_DAY = 48
BLOCK = 30 * 48  # steps per horizon block (30 days)


def block_r2(r2_t: np.ndarray) -> list:
    """The per-step R^2 averaged over each BLOCK steps (the last block may
    be short), labelled by day range."""
    return [
        {"days": f"{(i * BLOCK) // STEPS_PER_DAY}-{((i + 1) * BLOCK) // STEPS_PER_DAY}",
         "r2_mean": float(np.nanmean(r2_t[i * BLOCK:(i + 1) * BLOCK]))}
        for i in range((len(r2_t) + BLOCK - 1) // BLOCK)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=17520)  # one model year
    ap.add_argument("--train-days", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=1752)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "results_year_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.pipeline import ChunkDrain
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.evalx.metrics import r2_temporal
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.autoregressive import (
        make_rollout_fn,
        model_days_per_min,
    )
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    t0 = time.time()
    data = synthetic_e33oma_90d(T=args.steps, seed=7, H=GRID[0], W=GRID[1])
    print(f"year fixture T={args.steps}: {time.time() - t0:.0f}s", flush=True)

    n_train = args.train_days * STEPS_PER_DAY
    head = {k: (v if k == "static" else v[:n_train]) for k, v in data.items()}
    static = data["static"][:3]
    cfg = TrainConfig(
        model="LSTM-YEAR", species="bcb", in_channels=8,
        num_layers=len(HIDDEN), hidden_channels=HIDDEN, kernel_size=KERNELS,
        sequence_length=SEQ, num_epochs=args.epochs, batch_size=BATCH,
        input_size=PADDED, compute_dtype=DTYPE, checkpoint_every=args.epochs,
        snapshot_dir=os.path.join(args.out, "run"), device=args.device,
    )

    def mk(period):
        return SequenceDataset(head, period=period, sequence_length=SEQ, species="bcb",
                               in_channels=8)

    train_ds, val_ds = mk("train"), mk("val")
    bundle = build_model(cfg.model, in_channels=8, hidden_channels=HIDDEN,
                         kernel_sizes=KERNELS, compute_dtype=DTYPE, remat=True)
    cfg.dump()
    t0 = time.time()
    out = fit(bundle, train_ds, val_ds, cfg, device=device, static=static)
    train_s = time.time() - t0
    print(f"train {train_s:.0f}s", flush=True)

    rollout = make_rollout_fn(bundle.config, train_ds.normalizer, padded_shape=PADDED,
                              grid_shape=GRID, static=static)
    # the rest of the year through the carried-state rollout, host chunks
    forcings = np.stack([data["u"], data["v"], data["omega"], data["prec"],
                         data["bcb_src"]], axis=1).astype(np.float32)  # (T, 5, H, W)
    gts = data["bcb_conc"]
    state, n_steps = None, 0
    drain = ChunkDrain()  # dispatch chunk k+1 before fetching chunk k
    t0 = time.time()
    for s in range(n_train, args.steps, args.chunk):
        chunk = forcings[None, s:s + args.chunk]
        p, state = rollout(out["params"], chunk, state)
        drain.push(p[0])
        n_steps += chunk.shape[1]
    preds = np.concatenate(drain.finish())
    elapsed = time.time() - t0
    days_min = model_days_per_min(n_steps, elapsed)
    print(f"rollout {n_steps} steps in {elapsed:.1f}s = {days_min:.0f} model-days/min",
          flush=True)

    gt_tail = gts[n_train:n_train + preds.shape[0]]
    r2_t = r2_temporal(gt_tail, preds).numpy()
    result = {
        "config": "year-horizon closed-loop rollout, canonical 8ch surface",
        "train_days": args.train_days,
        "epochs": args.epochs,
        "train_wall_s": train_s,
        "final_val_r2": out["logger"]["r2_score_val"][-1],
        "rollout_steps": int(n_steps),
        "rollout_wall_s": elapsed,
        "rollout_days_per_min": days_min,
        "temporal_r2_overall_mean": float(np.nanmean(r2_t)),
        "temporal_r2_last30d_mean": float(np.nanmean(r2_t[-BLOCK:])),
        "temporal_r2_by_30d_block": block_r2(r2_t),
        "device": name,
    }
    print(json.dumps(result, indent=2), flush=True)
    with open(os.path.join(args.out, "results_year.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
