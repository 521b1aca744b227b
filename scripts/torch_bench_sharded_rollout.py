#!/usr/bin/env python3
"""The sharded rollout's cells compared on one device, the port's twin of
scripts/bench_sharded_rollout.py (config #5's serving path).

    python scripts/torch_bench_sharded_rollout.py [--steps 192] [--reps 3]
        [--cells plain kernel] [--device cuda]

Runs ``parallel/spatial.make_sharded_rollout_fn`` on a one-rank (1, 1, 1)
mesh (NCCL on the card, gloo on the CPU) at the north-star shapes: C = 62,
hidden 64/32/16, kernels 5/3/3, B 1, bf16, random weights from seed 0.
The forcings are uploaded once and stay on the device.  For each cell on
the halo-extended tiles (``plain``: the cell's plain PyTorch version;
``kernel``: B1) the rollout runs eagerly and as CUDA graph replays, each
after one call that warms it up (and captures the graph); one JSON line
per (cell, mode): host-clock ms/step over ``--reps`` calls,
model-days/min, and the mean of the last call's last map.  On the CPU the
call is eager too, so only ``eager`` lines are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

C, GRID, PADDED = 62, (90, 144), (100, 154)
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", nargs="*", default=["plain", "kernel"],
                    choices=("plain", "kernel"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)

    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.ops.convlstm_cell import (
        fused_cell_forward,
        fused_cell_forward_plain,
    )
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from nasa_niswan_tpu_torch.parallel.spatial import make_sharded_rollout_fn
    from nasa_niswan_tpu_torch.rollout.autoregressive import model_days_per_min
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    store = tempfile.mkdtemp(prefix="bench-sharded-")
    init_distributed("file://" + os.path.join(store, "store"), 1, 0,
                     device_type=device.type)
    try:
        mesh = make_mesh()
        cfg = ConvLSTMConfig(in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                             compute_dtype="bfloat16")
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=mesh.device)
        norm = Normalizer(np.zeros(C, np.float32), np.ones(C, np.float32), 0.0, 1.0)
        f = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (1, args.steps, C, *GRID), dtype=np.float32), device=mesh.device)
        cells = {"plain": fused_cell_forward_plain, "kernel": fused_cell_forward}
        modes = ("eager", "graph") if mesh.device.type == "cuda" else ("eager",)
        records = []
        for name in args.cells:
            ro = make_sharded_rollout_fn(cfg, norm, mesh, padded_shape=PADDED,
                                         grid_shape=GRID, cell_fn=cells[name])
            for mode in modes:
                run = ro if mode == "graph" else ro.eager
                p, _ = run(params, f)  # warm-up (and the graph's capture)
                _sync(mesh.device)
                tic = time.perf_counter()
                for _ in range(args.reps):
                    p, _ = run(params, f)
                _sync(mesh.device)
                dt = (time.perf_counter() - tic) / args.reps
                records.append({
                    "cell": name, "mode": mode,
                    "ms_per_step": round(dt / args.steps * 1e3, 4),
                    "days_per_min": round(model_days_per_min(args.steps, dt), 1),
                    "last_map_mean": float(p[0, -1].mean()),
                    "device": (torch.cuda.get_device_name(mesh.device)
                               if mesh.device.type == "cuda" else "cpu"),
                })
                print(json.dumps(records[-1]), flush=True)
        return records
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
