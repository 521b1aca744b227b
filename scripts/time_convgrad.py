"""Time the weight-gradient kernels (B2's dW, ``conv_dw``) and the SAME conv
(B3, ``conv_same``) on one NVIDIA GPU at the shapes of the training paths, to
compare two versions of ``csrc/cell_bwd.cu`` and ``csrc/conv_same.cu``
within one machine session.

``--root`` names the checkout whose ``nasa_niswan_tpu_torch`` is imported
(default: the one holding this script); its kernels are built there at the
first launch.  bf16 operands, B = 8 (the hoisted input conv: T*B = 384
frames), 100x154 (dW also on the halo-extended training tiles of the
(1, 1), (2, 2) and (2, 7) meshes, and at config #2's Cin 126), random
inputs from a seed.  Prints the card's name and power limit, the build
time, then per shape the mean time of one launch (CUDA events around
``--iters`` launches after a warm-up, L2 not flushed), eager and with the
launches captured in one CUDA graph and replayed (so the host's dispatch
drops out, as in a training step's graph; cuDNN eager alone), the least
time the card could take for the same work (dense bf16 peak and
HBM rate: the larger) and the one PyTorch call computing the same function
(cuDNN: ``conv2d_weight`` for dW, ``F.conv2d`` with a bf16 output for
B3), ``--reps`` times; last one JSON line with the means over the reps.
``--routes`` also times training steps of the root's package on the host
clock (synchronised, no profiler attached), ``--steps`` of them after one
warm-up: remat (the canonical windowed step), per-cell, seq2seq (config #3
on the per-cell route) and seq2seq-remat (its whole-chunk BPTT), at full
width as ``scripts/profile_torch_train_step.py`` builds them.

    python scripts/time_convgrad.py [--root DIR] [--iters 10] [--reps 2]
        [--routes remat,seq2seq] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (B, H, W, Cin, N, k) of every dW launch shape of the main paths: the three
# training layers, config #3's layer 1, the hoisted layer 0's h-conv, the
# hoisted input conv over all T*B frames
DW_SHAPES = (
    (8, 100, 154, 72, 256, 5),
    (8, 100, 154, 96, 128, 3),
    (8, 100, 154, 48, 64, 3),
    (8, 100, 154, 70, 256, 5),
    (8, 100, 154, 64, 256, 5),
    (384, 100, 154, 8, 256, 5),
    (8, 100, 154, 126, 256, 5),
)
# dW on the training tiles of the (1, 1), (2, 2) and (2, 7) meshes, each
# tile extended by its halo (parallel/spatial): layer 1 (k 5) 104 x 158 /
# 54 x 81 / 54 x 26, layers 2 and 3 (k 3) 102 x 156 / 52 x 79 / 52 x 24
DW_TILE_SHAPES = tuple(
    (8, h, w, cin, n, k)
    for cin, n, k, tiles in ((72, 256, 5, ((104, 158), (54, 81), (54, 26))),
                             (96, 128, 3, ((102, 156), (52, 79), (52, 24))),
                             (48, 64, 3, ((102, 156), (52, 79), (52, 24))))
    for h, w in tiles
)
# (B, H, W, Cin, Cout, k) of B3 as the data gradient dxh = conv_same(dgates,
# w'): the three training layers, config #3's layer 1, the 20-level fusion's
# layer 1
CONV_SHAPES = (
    (8, 100, 154, 256, 72, 5),
    (8, 100, 154, 128, 96, 3),
    (8, 100, 154, 64, 48, 3),
    (8, 100, 154, 256, 70, 5),
    (8, 100, 154, 256, 126, 5),
)
PEAK_BF16, HBM_BYTES_S = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3


def bound_ms(flops, nbytes):
    return 1e3 * max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)


def make_step(route, device):
    """One training step of ``route`` at full width (bs 8, T 48, hidden
    64/32/16, kernels 5/3/3, bf16, 100x154): ``step(s)`` runs step s."""
    import numpy as np
    import torch
    from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset, SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import (
        DeviceWindowSource,
        make_device_train_step,
        make_optimizer,
    )

    bs, T = 8, 48
    layers = dict(hidden_channels=(64, 32, 16), kernel_sizes=(5, 3, 3),
                  compute_dtype="bfloat16")
    geo = dict(padded_shape=(100, 154), grid_shape=(90, 144))
    data = synthetic_e33oma_90d(T=720, H=90, W=144, seed=0)
    if route.startswith("seq2seq"):
        ds = Seq2SeqDataset(data, period="train", sequence_length=T)
        cfg = ConvLSTMConfig(in_channels=6, remat=route == "seq2seq-remat", **layers)
        params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
        for t in param_leaves(params):
            t.requires_grad_(True)
        train_step = make_seq2seq_train_step(
            cfg, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)),
            external_draws=True, **geo)
        rng = np.random.default_rng(0)

        def step(s):
            items = [ds[(s + i) % len(ds)] for i in range(bs)]
            x, p0, y = (torch.as_tensor(np.stack(a), device=device) for a in zip(*items))
            train_step(params, x, p0, y, rng.random((T, bs)) < 0.5, 0.5)
        return step
    ds = SequenceDataset(data, period="train", sequence_length=T, in_channels=8)
    bundle = build_model("LSTM-time", in_channels=8, remat=route == "remat", **layers)
    params, state = bundle.init(torch.Generator().manual_seed(0), device)
    src = DeviceWindowSource(ds, device)
    train_step = make_device_train_step(
        bundle, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)), src,
        static=data["static"][:3], **geo)
    order = np.random.default_rng(0).permutation(src.n)

    def step(s):
        train_step(params, state, order[s * bs : (s + 1) * bs])
    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--routes", default="")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from nasa_niswan_tpu_torch.ops import _build, convgrad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"root {root}: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def ms(fn, replay=False):
        for _ in range(2):
            fn()
        run = lambda: [fn() for _ in range(args.iters)]  # noqa: E731
        if replay:
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run()
            graph.replay()
            run = graph.replay
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    cases = []
    for B, H, W, cin, n, k in DW_SHAPES + DW_TILE_SHAPES:
        x = torch.randn((B, H, W, cin), generator=gen, device=dev).bfloat16()
        g = torch.randn((B, H, W, n), generator=gen, device=dev).bfloat16()
        px = B * H * W
        cases.append((
            f"conv_dw B={B} H={H} W={W} Cin={cin} N={n} k={k}",
            lambda x=x, g=g, k=k: convgrad.conv_dw(x, g, k),
            lambda x=x, g=g, k=k, n=n, cin=cin: torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (n, cin, k, k), g.permute(0, 3, 1, 2), padding=k // 2),
            bound_ms(2.0 * px * k * k * cin * n, px * (cin + n) * 2 + k * k * cin * n * 4),
        ))
    for B, H, W, cin, cout, k in CONV_SHAPES:
        x = torch.randn((B, H, W, cin), generator=gen, device=dev).bfloat16()
        w = (torch.randn((k, k, cin, cout), generator=gen, device=dev)
             / (k * k * cin) ** 0.5).bfloat16()
        wn = w.permute(3, 2, 0, 1).contiguous()
        px = B * H * W
        cases.append((
            f"conv_same B={B} Cin={cin} Cout={cout} k={k}",
            lambda x=x, w=w: convgrad.conv_same(x, w),
            lambda x=x, wn=wn, k=k: torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), wn, padding=k // 2),
            bound_ms(2.0 * px * k * k * cin * cout, px * cin * 2 + k * k * cin * cout * 2
                     + px * cout * 4),
        ))

    sums = {}
    for rep in range(args.reps):
        for tag, fn, lib_fn, bound in cases:
            kernel, replay, library = ms(fn), ms(fn, replay=True), ms(lib_fn)
            print(f"rep {rep} {tag}: kernel {kernel:.4f} ms (replayed {replay:.4f} ms), "
                  f"library {library:.4f} ms, bound {bound:.4f} ms")
            s = sums.setdefault(tag, [0.0, 0.0, 0.0, bound])
            s[0] += kernel / args.reps
            s[1] += replay / args.reps
            s[2] += library / args.reps
    del cases
    torch.cuda.empty_cache()
    steps = {}
    for route in filter(None, args.routes.split(",")):
        step = make_step(route, dev)
        step(0)  # warm-up: allocator growth, kernel library load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, args.steps + 1):
            step(s)
        torch.cuda.synchronize()
        steps[route] = 1e3 * (time.perf_counter() - t0) / args.steps
        print(f"route {route}: {steps[route]:.1f} ms/step over {args.steps} steps")
        del step
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "device": smi, "ms": {
        tag: {"kernel": k, "replay": r, "library": lib, "bound": b}
        for tag, (k, r, lib, b) in sums.items()},
        "ms_per_step": steps}))


if __name__ == "__main__":
    main()
