#!/usr/bin/env python3
"""Config #4 on the port, the twin of scripts/run_train_year.py: a
multi-year-equivalent training campaign.

    python scripts/torch_run_train_year.py [--epochs 12] [--dp 1] [--device cuda]
        [--out FILE]

The canonical ConvLSTM (64/32/16, kernels 5/3/3, 8 inputs: 5 forcings + 3
static channels), bs 8, T 48, bf16, the remat route (kernels B1, B2, B3 on
the card), trained over the full 17,520-step fixture (one reference
training year), with StepLR(10, 0.9) applied after each epoch, validation
on ``--eval-windows`` windows per epoch and a checkpoint every
``--ckpt-every`` epochs.  Every training window is one emulated model-day
(T = 48 half-hour steps), so ``window_days_consumed / 365`` is the
campaign's years of training data.  ``--stride 48`` visits each day of the
training split once an epoch; ``--stride 1`` is the reference's sliding
window.

``--dp 1`` (default): the split's frame slab is uploaded once and each
step gathers its windows on the device by start index
(``train/loop.DeviceWindowSource``, ``make_device_train_step``).
``--dp N``: N ranks started by ``parallel/launch.spawn`` (one card each
with NCCL, or N CPU processes on gloo with ``--device cpu``), each with
the slab on its device and its share of every batch; one all-reduce of
the gradients a step (``build_train_step_fn(mesh=)``), the same loss and
R^2 as one device.  Per-batch metrics stay on the device and are fetched
once an epoch.  Writes ``--out`` (JSON, the JAX script's keys).
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
IN_CHANNELS = 8  # 5 forcings + 3 static channels
DTYPE = "bfloat16"
PAD = 10  # padded grid = grid + PAD per axis
_TMP = tempfile.gettempdir()


def _sizes() -> dict:
    """The widths, handed to each spawned rank (which imports this module
    anew)."""
    return dict(hidden=HIDDEN, kernels=KERNELS, dtype=DTYPE)


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=17520,
                    help="fixture length in 30-min steps (17520 = 1 year)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=48)
    ap.add_argument("--stride", type=int, default=48,
                    help="window-start stride per epoch (48 = daily "
                         "non-overlapping; 1 = reference sliding windows)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks, one device each (> 1: spawned)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-windows", type=int, default=64,
                    help="validation windows scored per epoch")
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--snapshot-dir", default=os.path.join(_TMP, "train_year_snapshots_torch"))
    ap.add_argument("--out", default=os.path.join(_TMP, "results_train_year_torch.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", type=int, nargs=2, default=[90, 144],
                    help="lat x lon grid (padding stays +10 per axis)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    if args.batch_size % args.dp:
        raise SystemExit("--batch-size must divide by --dp")
    import torch

    if args.dp > 1:
        from nasa_niswan_tpu_torch.parallel import launch

        device_type = torch.device(args.device).type
        result = launch.spawn(_campaign_rank, args.dp, device_type, vars(args), _sizes())[0]
    else:
        from nasa_niswan_tpu_torch.train.__main__ import resolve_device

        result = campaign(args, resolve_device(args.device), None, _sizes())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "epochs_log"}), flush=True)
    return result


def _campaign_rank(rank: int, args: dict, sizes: dict):
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=args["dp"])
    return campaign(argparse.Namespace(**args), mesh.device, mesh, sizes)


def campaign(args, device, mesh, sizes: dict) -> dict:
    """The campaign on ``device``, this rank's share of every batch on a
    (dp,) ``mesh`` when given (every rank returns the same result; rank 0
    prints and writes the checkpoints)."""
    import torch

    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.pipeline import shard_indices
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.checkpoint import save_checkpoint
    from nasa_niswan_tpu_torch.train.loop import (
        DeviceWindowSource,
        make_device_eval_step,
        make_device_train_step,
        make_optimizer,
        set_learning_rate,
    )
    from nasa_niswan_tpu_torch.train.schedule import step_lr

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    backend = device.type
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"[campaign] backend={backend} ({name}) ranks={args.dp} steps={args.steps} "
        f"epochs={args.epochs} dp={args.dp}", flush=True)

    tic = time.perf_counter()
    GH, GW = args.grid
    GRID, PADDED = (GH, GW), (GH + PAD, GW + PAD)
    data = synthetic_e33oma_90d(T=args.steps, seed=args.seed, H=GH, W=GW)
    say(f"[campaign] fixture built in {time.perf_counter() - tic:.1f}s", flush=True)
    ds_tr = SequenceDataset(data, period="train", sequence_length=args.seq_len,
                            in_channels=IN_CHANNELS)
    ds_va = SequenceDataset(data, period="val", sequence_length=args.seq_len,
                            in_channels=IN_CHANNELS)
    static = data["static"][:IN_CHANNELS - 5]

    bundle = build_model("LSTM-year-campaign", in_channels=IN_CHANNELS,
                         hidden_channels=tuple(sizes["hidden"]),
                         kernel_sizes=tuple(sizes["kernels"]),
                         compute_dtype=sizes["dtype"], remat=True)
    params, state = bundle.init(torch.Generator().manual_seed(args.seed), device)
    opt = make_optimizer(params, args.lr, (0.5, 0.999))
    rng = torch.Generator(device=device).manual_seed(args.seed + 1)

    src_tr = DeviceWindowSource(ds_tr, device)
    src_va = DeviceWindowSource(ds_va, device)
    geo = dict(padded_shape=PADDED, grid_shape=GRID, static=static, mesh=mesh)
    step_tr = make_device_train_step(bundle, ds_tr.normalizer, opt, src_tr, **geo)
    step_ev = make_device_eval_step(bundle, ds_va.normalizer, src_va, **geo)
    BS = args.batch_size
    shard = (0, 1) if mesh is None else (mesh.index("dp"), mesh.dp)

    def starts_of(idx):
        return torch.as_tensor(shard_indices(idx, BS, *shard))

    # epoch window starts: stride-subsampled, shuffled per epoch by
    # default_rng(seed + epoch), as the JAX script
    base_starts = np.arange(0, len(ds_tr), args.stride)
    va_step = max(1, len(ds_va) // max(1, args.eval_windows))
    va_starts = np.arange(0, len(ds_va), va_step)[: args.eval_windows]
    if len(base_starts) // BS == 0:
        raise SystemExit(
            f"fixture too small: {len(base_starts)} window starts at stride "
            f"{args.stride} yield zero full batches of {BS}"
        )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    epochs_log = []
    total_steps = 0
    lr = args.lr
    sync()
    campaign_tic = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        order = base_starts.copy()
        np.random.default_rng(args.seed + epoch).shuffle(order)
        n_batches = len(order) // BS
        ep_tic = time.perf_counter()
        # per-batch device scalars, fetched together once an epoch
        ep_losses, ep_r2s = [], []
        for b in range(n_batches):
            state, metrics = step_tr(params, state, starts_of(order[b * BS:(b + 1) * BS]), rng)
            ep_losses.append(metrics["loss"])
            ep_r2s.append(metrics["r2"])
        loss, train_r2 = torch.stack([torch.stack(ep_losses).mean(),
                                      torch.stack(ep_r2s).mean()]).tolist()
        ep_train_s = time.perf_counter() - ep_tic

        # StepLR(10, 0.9) after the epoch (train.py:71-72,120)
        new_lr = step_lr(args.lr, 10, 0.9, epoch)
        if new_lr != lr:
            set_learning_rate(opt, new_lr)
            lr = new_lr

        r2_chunks = [
            step_ev(params, state, starts_of(va_starts[s:s + BS]))[0]
            for s in range(0, len(va_starts) - len(va_starts) % BS, BS)
        ]
        val_r2 = float(torch.cat(r2_chunks).mean()) if r2_chunks else None
        total_steps += n_batches
        days = n_batches * BS * args.seq_len / 48.0
        row = {
            "epoch": epoch,
            "train_loss": loss,
            "train_r2": train_r2,
            "val_r2": val_r2,
            "lr": lr,
            "steps": n_batches,
            "train_s": ep_train_s,
            "days_per_min": days / (ep_train_s / 60.0),
        }
        epochs_log.append(row)
        say(f"[campaign] {json.dumps(row)}", flush=True)
        if lead and (epoch % args.ckpt_every == 0 or epoch == args.epochs):
            d = os.path.join(args.snapshot_dir, f"epoch-{epoch:03d}")
            save_checkpoint(d, params, opt, learning_rate=lr, epoch=epoch,
                            model_state=state)

    wall = time.perf_counter() - campaign_tic
    window_days = total_steps * BS * args.seq_len / 48.0
    steady = epochs_log[1:] or epochs_log  # drop the first (warm-up) epoch
    route = (f"data parallel over {args.dp} ranks, each with the slab on its device"
             if args.dp > 1 else "device-resident window slab")
    return {
        "what": "config #4 multi-year-equivalent training campaign (ConvLSTM %s, "
                "bs %d, T=%d, %s+remat; %s, kernels B1/B2/B3)"
                % ("/".join(map(str, sizes["hidden"])), BS, args.seq_len,
                   "bf16" if sizes["dtype"] == "bfloat16" else "f32", route),
        "backend": backend,
        "devices": args.dp,
        "device": name,
        "dp": args.dp,
        "fixture_steps": args.steps,
        "stride": args.stride,
        "epochs": args.epochs,
        "optimizer_steps": total_steps,
        "window_days_consumed": window_days,
        "years_equivalent": window_days / 365.0,
        "campaign_wall_s": wall,
        "steady_days_per_min": float(np.mean([e["days_per_min"] for e in steady])),
        "steady_days_per_min_median": float(np.median([e["days_per_min"] for e in steady])),
        "final_train_loss": epochs_log[-1]["train_loss"],
        "final_val_r2": epochs_log[-1]["val_r2"],
        "epochs_log": epochs_log,
    }


if __name__ == "__main__":
    main()
