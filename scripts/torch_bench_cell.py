#!/usr/bin/env python3
"""Cell shootout at the north-star rollout shapes on the port, the twin of
scripts/bench_cell.py.

    python scripts/torch_bench_cell.py [--steps 384] [--reps 3] [--impls ...]
        [--parity] [--train [--train-batches 4 8]] [--device cuda]

Sustained rollout step time across the cells and the input-conv hoist at
BASELINE config #2's shapes (the 20-level fusion, C = 62; ConvLSTM
64/32/16, kernels 5/3/3; bf16; batch 1; 90 x 144 padded to 100 x 154),
random weights from seed 0.  ``--impls`` takes cell:mode pairs: the cell is
``kernel`` (B1) or ``plain`` (its plain PyTorch version, printed for
reference and no yardstick), the mode ``hoist`` (``precompute_input_conv``)
or ``scan``.  The JAX script's ``xla``, ``pallas`` and ``pallas2`` cells
are TPU-only.  Every rollout is ``make_rollout_fn``: one CUDA graph replay
per call on a card.  One JSON line per variant: ms/step and model-days/min
over ``--reps`` calls after a warm-up call, and the last map's mean.  A
variant that fails raises (the JAX script reports and goes on).

``--parity`` first holds the kernel rollout against the plain one over
min(48, --steps) steps: the largest |d| of the predictions over the
largest |plain prediction| must stay below 0.05 (the JAX script's bound);
the measured value is printed.  ``--train`` times the training step
instead (``make_train_step``, Adam; 5 channels, T 48, the batch sizes of
``--train-batches``) on the per-cell route (``remat`` off) and the
whole-scan BPTT (``remat``), the best of ``--train-steps`` steps, each
synchronised on its loss; the JAX script's ``pallas2_xlabwd`` (an XLA
backward) is TPU-only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_trace_summary as ts  # noqa: E402
from torch_profile_rollout import CELL_FNS  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import (  # noqa: E402
    make_rollout_fn,
    model_days_per_min,
)
from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402

C = 3 * 20 + 2
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
TRAIN_C, TRAIN_T = 5, 48
PARITY_STEPS, PARITY_REL = 48, 0.05
MODES = ("hoist", "scan")


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--impls", nargs="*", default=["kernel:hoist", "kernel:scan", "plain:scan"],
                    help="cell:mode pairs; cell kernel or plain, mode hoist "
                         "(precompute_input_conv) or scan")
    ap.add_argument("--train", action="store_true",
                    help="benchmark the training step instead of the serving rollout")
    ap.add_argument("--train-batches", nargs="*", type=int, default=[4, 8])
    ap.add_argument("--train-steps", type=int, default=6)
    ap.add_argument("--parity", action="store_true",
                    help="before timing, hold the kernel rollout against the plain one")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    for spec in args.impls:
        impl, _, mode = spec.partition(":")
        if impl not in CELL_FNS or mode not in MODES:
            ap.error(f"--impls {spec}: want one of {sorted(CELL_FNS)}:{{hoist,scan}} "
                     "(the xla and pallas cells are TPU-only)")
    return args


def _cfg(channels: int) -> ConvLSTMConfig:
    return ConvLSTMConfig(in_channels=channels, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                          compute_dtype=DTYPE)


def parity(params, norm, forcings, device) -> dict:
    """The kernel rollout against the plain one over the first
    PARITY_STEPS steps; raises past PARITY_REL."""
    T_par = min(PARITY_STEPS, forcings.shape[1])
    outs = {}
    for impl in ("plain", "kernel"):
        rollout = make_rollout_fn(_cfg(C), norm, padded_shape=PADDED, grid_shape=GRID,
                                  precompute_input_conv=False, device=device,
                                  cell_fn=CELL_FNS[impl])
        preds, state = rollout(params, forcings[:, :T_par])
        outs[impl] = (preds.cpu().numpy(), state[0][0].cpu().numpy())
    scale = max(float(np.abs(outs["plain"][0]).max()), 1e-6)
    d_pred = np.abs(outs["plain"][0] - outs["kernel"][0])
    d_h = np.abs(outs["plain"][1] - outs["kernel"][1])
    rec = {"parity": "kernel-vs-plain bf16", "steps": T_par,
           "max_abs_pred": float(d_pred.max()), "max_rel_pred": float(d_pred.max()) / scale,
           "max_abs_h": float(d_h.max())}
    print(json.dumps(rec), flush=True)
    # bf16 has ~3 decimal digits; 48 recurrent steps compound ~2%
    if not rec["max_rel_pred"] < PARITY_REL:
        raise SystemExit(f"the kernel rollout diverges from the plain one: "
                         f"rel={rec['max_rel_pred']}")
    return rec


def serving_rows(args, device) -> list:
    norm = Normalizer(x_mean=np.zeros(C, np.float32), x_std=np.ones(C, np.float32),
                      y_mean=0.0, y_std=1.0)
    rng = np.random.default_rng(0)
    forcings = torch.as_tensor(
        rng.standard_normal((args.batch, args.steps, C, *GRID)).astype(np.float32),
        device=device)
    params = convlstm_init(torch.Generator().manual_seed(0), _cfg(C), device=device)
    rows = [parity(params, norm, forcings, device)] if args.parity else []
    for spec in args.impls:
        impl, _, mode = spec.partition(":")
        rollout = make_rollout_fn(_cfg(C), norm, padded_shape=PADDED, grid_shape=GRID,
                                  precompute_input_conv=mode == "hoist", device=device,
                                  cell_fn=CELL_FNS[impl])
        preds, _ = rollout(params, forcings)
        ref_last = preds[0, -1].cpu()
        tic = time.perf_counter()
        for _ in range(args.reps):
            preds, _ = rollout(params, forcings)
            preds[0, -1].cpu()
        elapsed = (time.perf_counter() - tic) / args.reps
        row = {"impl": spec, "ms_per_step": elapsed / args.steps * 1e3,
               "days_per_min": model_days_per_min(args.steps, elapsed, batch=args.batch),
               "last_map_mean": float(ref_last.mean())}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def train_rows(args, device) -> list:
    """Per batch size, the full training step (preprocess, forward,
    backward, Adam) on the per-cell route and the whole-scan BPTT."""
    rng = np.random.default_rng(0)
    norm = Normalizer(x_mean=np.zeros(TRAIN_C, np.float32),
                      x_std=np.ones(TRAIN_C, np.float32), y_mean=0.0, y_std=1.0)
    rows = []
    for B in args.train_batches:
        row = {"train_batch": B}
        x = torch.as_tensor(rng.standard_normal((B, TRAIN_T, TRAIN_C, *GRID)),
                            dtype=torch.float32, device=device)
        y = torch.as_tensor(rng.standard_normal((B, *GRID)), dtype=torch.float32,
                            device=device)
        for name, remat in (("per_cell", False), ("remat", True)):
            bundle = build_model("LSTM", in_channels=TRAIN_C, hidden_channels=HIDDEN,
                                 kernel_sizes=KERNELS, compute_dtype=DTYPE, remat=remat)
            params, state = bundle.init(torch.Generator().manual_seed(0), device)
            step = make_train_step(bundle, norm, make_optimizer(params, 1e-3, (0.9, 0.999)),
                                   padded_shape=PADDED, grid_shape=GRID)
            state, m = step(params, state, x, y)
            float(m["loss"])
            ts_ms = []
            for _ in range(args.train_steps):
                t0 = time.perf_counter()
                state, m = step(params, state, x, y)
                row[f"loss_{name}"] = float(m["loss"])
                ts_ms.append((time.perf_counter() - t0) * 1e3)
            row[f"ms_{name}"] = min(ts_ms)
        row["speedup_remat"] = row["ms_per_cell"] / row["ms_remat"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    args = _parse(argv)
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    card = ts.card(device)
    print(card, flush=True)
    rows = train_rows(args, device) if args.train else serving_rows(args, device)
    result = {"card": card, "rows": rows}
    ts.write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
