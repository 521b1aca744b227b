#!/usr/bin/env python3
"""Config #3's protocol on the port, the twin of
scripts/run_seq2seq_protocol.py: does scheduled sampling buy closed-loop
test skill?

    python scripts/torch_run_seq2seq_protocol.py [--epochs 25] [--steps 1440]
        [--schedule-k 5] [--batch 4] [--out DIR] [--device cuda]

Trains the 6-channel feedback emulator (5 forcings + the previous step's
concentration; ConvLSTM 64/32/16, kernels 5/3/3, bf16, the whole-chunk
BPTT route) twice at equal budget through ``rollout/seq2seq.fit_seq2seq``:
inverse-sigmoid scheduled sampling annealed deep (``--schedule-k``, teacher
probability down to ~0.05 at 25 epochs) and teacher forcing only (k =
1e6).  Each is then scored fully closed loop on the held-out test period
(``make_seq2seq_eval_step``: every step fed the model's own prediction),
the last batch padded with its last chunk.  Writes
``<out>/results_seq2seq.json`` with the per-epoch closed-loop validation
curves and the test closed-loop R^2 of both.
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
SEQ = 48
DTYPE = "bfloat16"


def closed_loop_test_r2(params, test_ds, batch_size: int, eval_step) -> float:
    """The closed-loop R^2 over every test chunk: batches of ``batch_size``,
    the last padded with its last chunk to keep the shape; each batch's R^2
    weighted by its real chunks (the duplicates still enter the last
    batch's own R^2, as in the JAX script).  The batch scores stay on the
    device until the end."""
    import torch

    n = len(test_ds)
    r2s, weights = [], []
    for s in range(0, n, batch_size):
        items = [test_ds[i] for i in range(s, min(s + batch_size, n))]
        weights.append(len(items))
        if len(items) < batch_size:
            items = items + [items[-1]] * (batch_size - len(items))
        xs, p0s, ys = zip(*items)
        _, r2v = eval_step(params, np.stack(xs), np.stack(p0s), np.stack(ys))
        r2s.append(r2v)
    r2s = torch.stack(r2s).double().cpu().numpy()
    return float(np.repeat(r2s, weights).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1440)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--schedule-k", type=float, default=5.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "seq2seq_protocol_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from nasa_niswan_tpu_torch.bridge import tree_leaves
    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.seq2seq import (
        fit_seq2seq,
        inverse_sigmoid_schedule,
        make_seq2seq_eval_step,
    )
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    t0 = time.time()
    data = synthetic_e33oma_90d(T=args.steps, seed=7, H=GRID[0], W=GRID[1])
    print(f"fixture: {time.time() - t0:.0f}s", flush=True)

    def mk(period):
        return Seq2SeqDataset(data, period=period, species="bcb", sequence_length=SEQ)

    train_ds, val_ds, test_ds = mk("train"), mk("val"), mk("test")
    print(f"chunks train/val/test = {len(train_ds)}/{len(val_ds)}/{len(test_ds)}",
          flush=True)
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype=DTYPE, remat=True)
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    eval_step = make_seq2seq_eval_step(cfg, train_ds.normalizer, **geo)

    report = {
        "config": "seq2seq protocol: deep-annealed scheduled sampling vs "
                  "teacher-only, closed-loop test eval",
        "epochs": args.epochs,
        "final_teacher_prob_scheduled": inverse_sigmoid_schedule(args.epochs,
                                                                 args.schedule_k),
        "device": name,
    }
    for label, k in (("scheduled", args.schedule_k), ("teacher_only", 1e6)):
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        t0 = time.time()
        params, _, history = fit_seq2seq(
            cfg, params, train_ds, val_dataset=val_ds, normalizer=train_ds.normalizer,
            num_epochs=args.epochs, batch_size=args.batch, schedule_k=k,
            snapshot_dir=os.path.join(args.out, label), checkpoint_every=args.epochs,
            **geo,
        )
        test_r2 = closed_loop_test_r2(params, test_ds, args.batch, eval_step)
        report[label] = {
            "wall_s": time.time() - t0,
            "val_r2_curve": [h["r2_val"] for h in history],
            "test_closed_loop_r2": test_r2,
        }
        print(f"[{label}] test closed-loop R2 = {test_r2:.4f}", flush=True)

    print(json.dumps(report, indent=2), flush=True)
    with open(os.path.join(args.out, "results_seq2seq.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
