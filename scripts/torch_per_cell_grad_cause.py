#!/usr/bin/env python3
"""Where the per-cell route's bf16 gradient on a one-rank sharded mesh
parts from the single-device per-cell step's.

    python scripts/torch_per_cell_grad_cause.py [--device cuda] [--seq 48]

The canonical training step (bs 8, 5 forcings + 3 static channels, hidden
64/32/16, kernels 5/3/3, bf16, 90 x 144 padded to 100 x 154, the synthetic
fixture of seed 0) on the per-cell route, one step from the same weights
and batch: ``make_train_step`` on the device, and ``make_spatial_train_step``
on a one-rank (1, 1, 1) mesh (NCCL on a card, gloo on the CPU), whose tile
is the zero-extended frame.  Each cell call's f32 weight gradient (the
``dw`` of the per-cell VJP: B2's dW kernels on the card) is recorded in
both.  Prints one JSON line:

* per layer, over the cell calls: the largest distance of the sharded
  call's dW from the device call's (relative to the call's largest
  entry), and the share of the entries that round to another bf16;
* per parameter leaf, relative to the leaf's largest: the sharded step's
  gradient against the device step's, and each against the f32 sum of the
  device step's own per-call dW (the biases are summed in f32 by both).

On one rank no halo is exchanged, so the two steps differ only in the
frame each cell's sums run over (the extended frame's pixels are summed
in another order); what a leaf shows beyond that comes from how the steps
are summed: in bf16 by the device step (each call's dW cast to the bf16
kernel, as JAX's ``_v2_bwd`` returns it), in f32 by the sharded step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

GRID, PADDED = (90, 144), (100, 154)
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
BS, C_IN = 8, 8  # 5 forcings + 3 static channels


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=48, help="window length T")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)

    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.ops import convlstm_cell
    from nasa_niswan_tpu_torch.parallel import spatial
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    data = synthetic_e33oma_90d(T=720, H=GRID[0], W=GRID[1], seed=0)
    ds = SequenceDataset(data, period="train", sequence_length=args.seq, in_channels=C_IN)
    idx = np.random.default_rng(0).permutation(len(ds))[:BS]
    x, y = (np.stack(a) for a in zip(*(ds[int(i)] for i in idx)))
    geo = dict(padded_shape=PADDED, grid_shape=GRID, static=data["static"][: C_IN - 5])
    bundle = build_model("LSTM-cause", remat=False, in_channels=C_IN, hidden_channels=HIDDEN,
                         kernel_sizes=KERNELS, compute_dtype="bfloat16")
    init, _ = bundle.init(torch.Generator().manual_seed(0), device)

    calls = []
    vjp = convlstm_cell._cell_vjp

    def recorded(*a):
        out = vjp(*a)
        calls[-1].append(out[3].float().clone())
        return out

    def run(make_step):
        params = _copy(init)
        calls.append([])
        make_step(params)(params, None, x, y)
        return [t.grad.float() for t in param_leaves(params)], calls[-1]

    store = tempfile.mkdtemp(prefix="grad-cause-")
    init_distributed("file://" + os.path.join(store, "store"), 1, 0, device_type=device.type)
    convlstm_cell._cell_vjp = spatial._cell_vjp = recorded
    try:
        mesh = make_mesh()
        g_dev, dw_dev = run(lambda p: make_train_step(
            bundle, ds.normalizer, make_optimizer(p, 1e-3, (0.5, 0.999)), **geo))
        g_sh, dw_sh = run(lambda p: spatial.make_spatial_train_step(
            bundle, ds.normalizer, make_optimizer(p, 1e-3, (0.5, 0.999)), mesh, **geo))
    finally:
        convlstm_cell._cell_vjp = spatial._cell_vjp = vjp
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    layers, f32_sum = [], []
    for li, hid in enumerate(HIDDEN):
        pairs = [(a, b) for a, b in zip(dw_sh, dw_dev) if a.shape[-1] == 4 * hid
                 and a.shape[2] == (C_IN if li == 0 else HIDDEN[li - 1]) + hid]
        layers.append({
            "layer": li + 1, "cell_calls": len(pairs),
            "dw_call_rel_max": max(_rel(a, b) for a, b in pairs),
            "dw_call_bf16_flip_share": float(np.mean([
                float((a.bfloat16() != b.bfloat16()).float().mean()) for a, b in pairs])),
        })
        f32_sum.append(torch.stack([b for _, b in pairs]).sum(0))
    names, ref = [], []
    for li, s in enumerate(f32_sum):
        cin = C_IN if li == 0 else HIDDEN[li - 1]
        names += [f"cells/{li}/b", f"cells/{li}/w_h", f"cells/{li}/w_x"]
        ref += [None, s[:, :, cin:], s[:, :, :cin]]
    names += ["head/b", "head/w"]
    ref += [None, None]
    leaves = [{
        "leaf": n, "sharded_vs_device": _rel(a, b),
        "device_vs_f32_sum": None if r is None else _rel(b, r),
        "sharded_vs_f32_sum": None if r is None else _rel(a, r),
    } for n, a, b, r in zip(names, g_sh, g_dev, ref)]
    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "seq": args.seq, "layers": layers, "leaves": leaves}
    print(json.dumps(out), flush=True)
    return out


def _copy(tree):
    from nasa_niswan_tpu_torch.bridge import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


if __name__ == "__main__":
    main()
