#!/usr/bin/env python3
"""The round-2 demonstration on the port, the twin of
scripts/run_results_r02.py: configs #2 and #3 at the canonical width on a
30-day fixture with 20 vertical levels (1,440 steps at 90 x 144).

    python scripts/torch_run_results_r02.py [--epochs 12] [--epochs-b 12]
        [--steps 1440] [--skip-a] [--skip-b] [--out DIR] [--device cuda]

A. config #2: the 20 levels fused to C = 62 channels
   (``data/fusion.fuse_levels``), windowed training (bs 4, bf16, the remat
   route: B1, B2, B3 on the card); the test period scored windowed
   (``predict_test_set``) and by the state-carrying rollout
   (``predict_test_rollout``), and by the rollout with layer 0's input conv
   hoisted (B1's xg mode; its distance from the unhoisted rollout beside
   it); the rollout in bf16 against f32 over the whole test tail, in
   chunks of DRIFT_CHUNK steps (the drift).
B. config #3 on the surface slice: seq2seq scheduled sampling (k = 10)
   against teacher forcing only (k = 1e6), each ``fit_seq2seq`` with its
   closed-loop validation curve.

Writes ``<out>/results_r02.json`` with the JAX script's keys.
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
LEVELS = 20
SEQ = 48
DTYPE = "bfloat16"
DRIFT_CHUNK = 192


def run_a(data, out_dir: str, epochs: int, device) -> dict:
    import torch

    from nasa_niswan_tpu_torch.core.grid import GridSpec
    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.fusion import fuse_levels
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        evaluation_report,
        predict_test_rollout,
        predict_test_set,
    )
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    fused = fuse_levels(data, "bcb", levels=LEVELS)
    C = fused[0].shape[1]

    def mk(period):
        return SequenceDataset(fused, period=period, sequence_length=SEQ, species="bcb")

    train_ds, val_ds, test_ds = mk("train"), mk("val"), mk("test")
    print(f"[A] fused C={C}, windows train/val/test = "
          f"{len(train_ds)}/{len(val_ds)}/{len(test_ds)}", flush=True)
    cfg = TrainConfig(
        model="LSTM-FUSE20-r02", species="bcb", in_channels=C, levels=LEVELS,
        num_layers=len(HIDDEN), hidden_channels=HIDDEN, kernel_size=KERNELS,
        sequence_length=SEQ, num_epochs=epochs, batch_size=4, input_size=PADDED,
        compute_dtype=DTYPE, checkpoint_every=max(epochs // 3, 1),
        snapshot_dir=os.path.join(out_dir, "runA"), device=str(device),
    )
    bundle = build_model(cfg.model, in_channels=C, hidden_channels=HIDDEN,
                         kernel_sizes=KERNELS, compute_dtype=DTYPE, remat=True)
    cfg.dump()
    t0 = time.time()
    out = fit(bundle, train_ds, val_ds, cfg, device=device)
    train_s = time.time() - t0

    t0 = time.time()
    win = predict_test_set(bundle, out["params"], out["state"], test_ds,
                           padded_shape=PADDED, batch_size=8)
    windowed_s = time.time() - t0
    t0 = time.time()
    rol = predict_test_rollout(bundle.config, out["params"], test_ds, padded_shape=PADDED)
    rollout_s = time.time() - t0

    # the same rollout with layer 0's input conv hoisted (one conv over all
    # frames, then B1's xg mode)
    frames, _ = test_ds.forcing_stream()
    hoisted = make_rollout_fn(bundle.config, test_ds.normalizer, padded_shape=PADDED,
                              grid_shape=GRID, precompute_input_conv=True)
    t0 = time.time()
    p_h, _ = hoisted(out["params"], frames[None])
    p_h = p_h[0, test_ds.seq_len - 1:].cpu().numpy()
    hoisted_s = time.time() - t0

    grid = GridSpec(nlat=GRID[0], nlon=GRID[1])
    rep_w = evaluation_report(win["GTs"], win["PDs"], grid.lat, grid.lon)
    rep_r = evaluation_report(rol["GTs"], rol["PDs"], grid.lat, grid.lon)
    rep_h = evaluation_report(rol["GTs"], p_h, grid.lat, grid.lon)

    # bf16 against f32 closed-loop drift over the whole test tail
    trajs = {}
    for dt in ("bfloat16", "float32"):
        rcfg = ConvLSTMConfig(in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                              compute_dtype=dt)
        r = make_rollout_fn(rcfg, test_ds.normalizer, padded_shape=PADDED, grid_shape=GRID)
        preds, state = [], None
        for s in range(0, frames.shape[0], DRIFT_CHUNK):
            p, state = r(out["params"], frames[None, s:s + DRIFT_CHUNK], state)
            preds.append(p[0])
        trajs[dt] = torch.cat(preds).cpu().numpy()
    diff = trajs["bfloat16"] - trajs["float32"]
    scale = float(np.std(trajs["float32"])) + 1e-12
    nrmse_t = np.sqrt((diff ** 2).mean(axis=(1, 2))) / scale

    def summary(rep, wall):
        return {"temporal_r2": rep["temporal_r2_summary"], "global_r2": rep["global_r2"],
                "pearson_r": rep["pearson_r"], "wall_s": wall}

    result = {
        "config": "A: 20-level fusion (C=62), windowed train, canonical grid",
        "epochs": epochs,
        "train_wall_s": train_s,
        "final_train_r2": out["logger"]["r2_score"][-1],
        "final_val_r2": out["logger"]["r2_score_val"][-1],
        "windowed": summary(rep_w, windowed_s),
        "rollout": summary(rep_r, rollout_s),
        "rollout_hoisted": dict(
            summary(rep_h, hoisted_s),
            max_abs_diff_over_std=float(np.abs(p_h - rol["PDs"]).max()
                                        / (np.std(rol["PDs"]) + 1e-12))),
        "bf16_drift_vs_f32": {
            "nrmse_first100_mean": float(nrmse_t[:100].mean()),
            "nrmse_last100_mean": float(nrmse_t[-100:].mean()),
            "nrmse_max": float(nrmse_t.max()),
        },
    }
    print("[A]", json.dumps(result, indent=2), flush=True)
    return result


def run_b(data, out_dir: str, epochs: int, device) -> dict:
    import torch

    from nasa_niswan_tpu_torch.bridge import tree_leaves
    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.seq2seq import fit_seq2seq

    def mk(period):
        return Seq2SeqDataset(data, period=period, species="bcb", sequence_length=SEQ)

    train_ds, val_ds = mk("train"), mk("val")
    print(f"[B] seq2seq chunks train/val = {len(train_ds)}/{len(val_ds)}", flush=True)
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype=DTYPE, remat=True)
    results = {}
    for label, k in (("scheduled", 10.0), ("teacher_only", 1e6)):
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        t0 = time.time()
        _, _, history = fit_seq2seq(
            cfg, params, train_ds, val_dataset=val_ds, padded_shape=PADDED,
            grid_shape=GRID, num_epochs=epochs, batch_size=4, schedule_k=k,
            snapshot_dir=os.path.join(out_dir, f"runB_{label}"), checkpoint_every=epochs,
        )
        results[label] = {
            "wall_s": time.time() - t0,
            "teacher_prob_final": history[-1]["teacher_prob"],
            "closed_loop_val_r2": [h["r2_val"] for h in history],
        }
        print(f"[B:{label}]", json.dumps(results[label]), flush=True)
    return {"config": "B: seq2seq 6ch scheduled sampling vs teacher-only",
            "epochs": epochs, **results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--epochs-b", type=int, default=12)
    ap.add_argument("--steps", type=int, default=1440)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "results_r02_torch"))
    ap.add_argument("--skip-a", action="store_true")
    ap.add_argument("--skip-b", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    t0 = time.time()
    data = synthetic_e33oma_90d(T=args.steps, seed=7, H=GRID[0], W=GRID[1], nlev=LEVELS)
    print(f"fixture T={args.steps} {GRID[0]}x{GRID[1]}x{LEVELS}: {time.time() - t0:.0f}s",
          flush=True)

    report = {}
    if not args.skip_a:
        report["A"] = run_a(data, args.out, args.epochs, device)
    if not args.skip_b:
        # seq2seq runs at the surface (level-0) slice of the same fixture
        surf = {k: (v[:, 0] if v.ndim == 4 and k != "static" else v)
                for k, v in data.items()}
        report["B"] = run_b(surf, args.out, args.epochs_b, device)
    path = os.path.join(args.out, "results_r02.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print("WROTE", path, flush=True)
    return report


if __name__ == "__main__":
    main()
