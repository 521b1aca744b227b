#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Drives the port's serving and training paths (``nasa_niswan_tpu_torch``) at
full width and checks them; imports nothing of JAX or of the JAX package.
Phases, each printing its own lines:

  (a) device: the card's name and power limit as nvidia-smi reports them;
  (b) build: nvcc builds csrc/*.cu for sm_90a; the build time and ptxas's
      register / shared-memory report;
  (c) kernel vs plain: the fused ConvLSTM cell kernel against its plain
      PyTorch version (f32 conv, TF32 off) at the three serving layer shapes
      and one ragged shape, bf16 and f32; max |dh|, |dc| <= 1e-3 and two
      runs bit-identical; kernel and plain times (CUDA events);
  (d) serve: the canonical C=62 model (20-level fusion, hidden 64/32/16,
      kernels 5/3/3, 100x154 padded grid), random weights from a seed, bf16,
      B=1: four 48-step requests chained through the carry, with exactly
      3 x 4 x 48 kernel launches, finite outputs, one 48-step request equal
      to two 24-step ones, a few streaming steps equal to the rollout, and
      request 1 re-run on the plain path: rms |d| <= 2e-2 of the plain
      predictions' std, max |d| no more than twice the plain path's own
      difference between two summation orders (card vs CPU), and in f32
      max |d| <= 1e-4 of the std;
  (e) time: the sustained rate of (d), kernel and plain path (informational);
  (f) backward kernels vs plain: the fused cell backward (B2) and the SAME
      data-gradient conv (B3) against their plain PyTorch versions at the
      three training layer shapes (B=8, 100x154) and one ragged shape, bf16
      and f32, with the bounds in BWD_BOUNDS; two runs bit-identical; kernel
      and plain times (CUDA events);
  (g) train: the canonical training step (bs 8, T 48, 8 input channels,
      hidden 64/32/16, kernels 5/3/3, bf16, 100x154, Adam lr 1e-3 betas
      (0.5, 0.999)) on the synthetic fixture (T=720, 90x144, seed 0): one
      warm-up step, then 3 optimizer steps through make_device_train_step
      with exactly 3 x 48 x 3 launches of each of B1, B2, B3, finite loss and
      parameters; the parameter gradients at T=8 against eager autograd
      through the plain cell, per leaf relative to the plain gradient's norm
      (TOL_GRAD); one epoch of the training CLI's main on a small fixture,
      whose logger.npy and checkpoint load back;
  (h) time: training ms/step and model-days/min (BS*T/48 per step), kernel
      and plain path (informational).

Then one JSON line describing each kernel, and last the device line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  It also exits non-zero when no CUDA
device is visible.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nasa_niswan_tpu_torch.data.dataset import (
    Normalizer,
    SequenceDataset,
    zscore_static,
)
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.ops import _build, convgrad, convlstm_cell
from nasa_niswan_tpu_torch.ops.convgrad import (
    cell_grads_plain,
    conv_same,
    conv_same_plain,
    flip_kernel,
    fused_cell_bwd,
    fused_cell_bwd_plain,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import (
    fused_cell_forward,
    fused_cell_forward_plain,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    make_rollout_fn,
    make_streaming_rollout,
    model_days_per_min,
)
from nasa_niswan_tpu_torch.train import __main__ as train_cli
from nasa_niswan_tpu_torch.train.checkpoint import load_checkpoint, param_leaves
from nasa_niswan_tpu_torch.train.config import TrainConfig
from nasa_niswan_tpu_torch.train.loop import (
    DeviceWindowSource,
    _device_preprocess,
    make_device_train_step,
    make_loss_fn,
    make_optimizer,
)

SEED = 0
C = 3 * 20 + 2  # 20-level fusion: u/v/omega per level + prec + emission
HIDDEN = (64, 32, 16)
KERNELS = (5, 3, 3)
GRID = (90, 144)
PADDED = (100, 154)
STEPS = 48  # one request = one model day at 30-min steps
N_REQUESTS = 4
# (B, H, W, Cin, hidden, k): the three serving layers, then a ragged shape
CELL_SHAPES = (
    (1, 100, 154, C + 64, 64, 5),
    (1, 100, 154, 64 + 32, 32, 3),
    (1, 100, 154, 32 + 16, 16, 3),
    (2, 20, 28, 13, 16, 5),
)
TOL_CELL = 1e-3  # f32 sums in another order over K <= 3,150 terms
TOL_CHUNK = 1e-6  # same launches on the same data: expected bit-exact
TOL_PLAIN_REL = 2e-2  # bf16 rollout, rms |kernel - plain| / std(plain)
TOL_F32_REL = 1e-4  # f32 rollout, max |kernel - plain| / std(plain)

# training: the canonical step of bench.py's main_train
TRAIN_BS, TRAIN_T, TRAIN_C = 8, 48, 8  # 5 forcings + 3 static channels
TRAIN_STEPS = 3
GRAD_T = 8  # eager autograd keeps every intermediate: T=48 would not fit
# (B, H, W, Cin, hidden, k): the three training layers, then a ragged shape
# (rows, columns and the 126 channels of the 20-level fusion's layer 1)
BWD_SHAPES = (
    (TRAIN_BS, 100, 154, TRAIN_C + 64, 64, 5),
    (TRAIN_BS, 100, 154, 64 + 32, 32, 3),
    (TRAIN_BS, 100, 154, 32 + 16, 16, 3),
    (2, 37, 45, C + 64, 64, 5),
)
# kernel vs plain: dgates within one bf16 step (2**-7 relative; f32 1e-5)
# plus 1e-5; dc_prev 1e-4; dw, db and dxh relative to their largest entry
BWD_BOUNDS = {"dc_prev": 1e-4, "dw": 1e-3, "db": 1e-4, "dxh": 2e-4}
# per-leaf |g_kernel - g_plain| / |g_plain| at T=8: bf16 rounds dgates, dw
# and dxh at other places than eager autograd does; f32 sums in other orders
TOL_GRAD = {"bfloat16": 5e-2, "float32": 1e-4}

KERNEL_SOURCES = {
    "convlstm_cell": ("nasa_niswan_tpu_torch/csrc/convlstm_cell.cu",
                      "nasa_niswan_tpu/ops/convlstm_pallas2.py:176"),
    "cell_bwd": ("nasa_niswan_tpu_torch/csrc/cell_bwd.cu",
                 "nasa_niswan_tpu/ops/convgrad_pallas.py:127"),
    "conv_same": ("nasa_niswan_tpu_torch/csrc/conv_same.cu",
                  "nasa_niswan_tpu/ops/convgrad_pallas.py:57"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, n: int = 20) -> float:
    """Mean device time of ``fn`` over ``n`` launches, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(
        f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}"
    )
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_kernels()
    print(
        f"[b] {lib_path.name} built by nvcc ({' '.join(_build.NVCC_FLAGS)}) "
        f"from {_build.CSRC_DIR.name}/*.cu in {time.perf_counter() - t0:.1f} s"
    )
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[b] {line.strip()}")


def phase_kernel_vs_plain(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err, ms_step, plain_ms_step = 0.0, 0.0, 0.0
    for B, H, W, cin, hid, k in CELL_SHAPES:
        xh32 = torch.randn((B, H, W, cin), generator=gen, device=device)
        c = torch.randn((B, H, W, hid), generator=gen, device=device)
        w32 = torch.randn((k, k, cin, 4 * hid), generator=gen, device=device)
        w32 /= (k * k * cin) ** 0.5
        b = 0.1 * torch.randn((4 * hid,), generator=gen, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            xh, w = xh32.to(dtype), w32.to(dtype)
            h1, c1 = fused_cell_forward(xh, c, w, b)
            h1b, c1b = fused_cell_forward(xh, c, w, b)
            h2, c2 = fused_cell_forward_plain(xh, c, w, b)
            torch.cuda.synchronize()
            check(torch.equal(h1, h1b) and torch.equal(c1, c1b),
                  f"kernel not deterministic at {(B, H, W, cin, hid, k)} {dtype}")
            dh = (h1 - h2).abs().max().item()
            dc = (c1 - c2).abs().max().item()
            ms = cuda_ms(lambda: fused_cell_forward(xh, c, w, b))
            plain_ms = cuda_ms(lambda: fused_cell_forward_plain(xh, c, w, b))
            print(
                f"[c] B={B} H={H} W={W} Cin={cin} hid={hid} k={k} "
                f"{str(dtype).split('.')[-1]}: max|dh|={dh:.3e} max|dc|={dc:.3e} "
                f"(tol {TOL_CELL:g}), bit-identical reruns; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            )
            check(dh <= TOL_CELL and dc <= TOL_CELL,
                  f"kernel vs plain {dh:.3e}/{dc:.3e} > {TOL_CELL:g}")
            max_err = max(max_err, dh, dc)
            if dtype == torch.bfloat16 and H == PADDED[0] and W == PADDED[1]:
                ms_step += ms
                plain_ms_step += plain_ms
    print(
        f"[c] one serving step's three cells, bf16: kernel {ms_step:.4f} ms, "
        f"plain {plain_ms_step:.4f} ms"
    )
    return {"max_abs_err": max_err, "ms": ms_step, "plain_ms": plain_ms_step}


def phase_serve(device) -> dict:
    cfg = ConvLSTMConfig(
        in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
        compute_dtype="bfloat16",
    )
    params = convlstm_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    rng = np.random.default_rng(SEED)
    host = [
        rng.standard_normal((1, STEPS, C, *GRID), dtype=np.float32)
        for _ in range(N_REQUESTS)
    ]
    stack = np.stack(host)
    norm = Normalizer(
        x_mean=stack.mean(axis=(0, 1, 2, 4, 5), dtype=np.float64).astype(np.float32),
        x_std=stack.std(axis=(0, 1, 2, 4, 5), dtype=np.float64).astype(np.float32),
        y_mean=0.0,
        y_std=1.0,
    )
    del stack
    forcings = [torch.from_numpy(f).to(device) for f in host]
    kwargs = dict(padded_shape=PADDED, grid_shape=GRID, device=device)
    rollout = make_rollout_fn(cfg, norm, **kwargs)
    plain = make_rollout_fn(
        cfg, norm, cell_fn=fused_cell_forward_plain, **kwargs
    )
    # warm-up at the request shape (the allocator grows to it once),
    # outside the counted and timed run
    for fn in (rollout, plain):
        fn(params, forcings[0])
    torch.cuda.synchronize()

    # the counted main path: N_REQUESTS requests chained through the carry
    convlstm_cell.launches = 0
    t0 = time.perf_counter()
    state, preds = None, []
    for f in forcings:
        p, state = rollout(params, f, state)
        preds.append(p)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = convlstm_cell.launches
    want = len(HIDDEN) * N_REQUESTS * STEPS
    print(f"[d] served {N_REQUESTS} requests x {STEPS} steps through the carry: "
          f"{launches} kernel launches (want {want})")
    check(launches == want, f"{launches} kernel launches, want {want}")
    for p in preds:
        check(tuple(p.shape) == (1, STEPS, *GRID), f"pred shape {tuple(p.shape)}")
        check(bool(torch.isfinite(p).all()), "non-finite prediction")
    for h, c in state:
        check(bool(torch.isfinite(h).all() and torch.isfinite(c).all()),
              "non-finite carry")
    print(f"[d] all predictions finite, shape (1, {STEPS}, {GRID[0]}, {GRID[1]})")

    # one 48-step request == two 24-step requests chained
    p_one, s_one = rollout(params, forcings[0])
    half = STEPS // 2
    p_a, s_a = rollout(params, forcings[0][:, :half])
    p_b, s_b = rollout(params, forcings[0][:, half:], s_a)
    d_chunk = (torch.cat([p_a, p_b], dim=1) - p_one).abs().max().item()
    d_state = max(
        (x - y).abs().max().item()
        for (h1, c1), (h2, c2) in zip(s_b, s_one)
        for x, y in ((h1, h2), (c1, c2))
    )
    d_first = (p_one - preds[0]).abs().max().item()
    print(f"[d] chunked vs one-shot: max|dpred|={d_chunk:.3e} "
          f"max|dstate|={d_state:.3e}; rerun vs served request 1 {d_first:.3e} "
          f"(tol {TOL_CHUNK:g})")
    check(max(d_chunk, d_state, d_first) <= TOL_CHUNK, "chunked != one-shot")

    step = make_streaming_rollout(cfg, norm, params, **kwargs)
    d_stream = max(
        (step(forcings[0][:, t]) - preds[0][:, t]).abs().max().item()
        for t in range(3)
    )
    print(f"[d] streaming 3 single steps vs request 1: max|dpred|={d_stream:.3e}")
    check(d_stream <= TOL_CHUNK, "streaming != rollout")

    # the plain path on the card, same requests, timed the same way
    t0 = time.perf_counter()
    state_p, preds_p = None, []
    for f in forcings:
        p, state_p = plain(params, f, state_p)
        preds_p.append(p)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0

    # Request 1 against the plain path.  In bf16 the head's product is
    # rounded to bf16 (the JAX dtype rule), so any two summation orders
    # differ by a few bf16 quanta of it: the plain path on the CPU is the
    # second order, and the kernel may be no further from the card's plain
    # path than that.  In f32 the paths agree to the f32 sums.
    ref = preds_p[0]
    plain_cpu = make_rollout_fn(
        cfg, norm, padded_shape=PADDED, grid_shape=GRID, device="cpu",
        cell_fn=fused_cell_forward_plain,
    )
    p_cpu, _ = plain_cpu(_tree_to(params, "cpu"), host[0])
    rel = lambda p: rel_err(p.to(ref.device), ref)  # noqa: E731
    (k_max, k_rms), (o_max, o_rms) = rel(preds[0]), rel(p_cpu)
    print(f"[d] request 1, bf16, std(plain) {ref.std().item():.4e}: kernel vs "
          f"plain max|d|/std={k_max:.3e} rms/std={k_rms:.3e}; plain on the CPU "
          f"vs plain max|d|/std={o_max:.3e} rms/std={o_rms:.3e}")
    check(k_rms <= TOL_PLAIN_REL, f"kernel vs plain rms/std {k_rms:.3e}")
    check(k_max <= 2 * o_max, f"kernel vs plain max/std {k_max:.3e} > 2 x "
          f"the plain path's own {o_max:.3e}")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32, _ = make_rollout_fn(cfg32, norm, **kwargs)(params, forcings[0])
    q32, _ = make_rollout_fn(
        cfg32, norm, cell_fn=fused_cell_forward_plain, **kwargs
    )(params, forcings[0])
    f_max, f_rms = rel_err(p32, q32)
    print(f"[d] request 1, f32: kernel vs plain max|d|/std={f_max:.3e} "
          f"rms/std={f_rms:.3e} (tol {TOL_F32_REL:g})")
    check(f_max <= TOL_F32_REL, f"f32 kernel vs plain rollout {f_max:.3e}")
    return {"launches": launches, "t_kernel": t_kernel, "t_plain": t_plain}


def rel_err(p: torch.Tensor, ref: torch.Tensor):
    """(max, rms) of |p - ref| over std(ref)."""
    d = (p - ref).abs()
    std = ref.std()
    return (d.max() / std).item(), (d.pow(2).mean().sqrt() / std).item()


def _tree_to(params, device):
    return {
        "cells": [{k: v.to(device) for k, v in c.items()} for c in params["cells"]],
        "head": {k: v.to(device) for k, v in params["head"].items()},
    }


def _max_excess(got, want, rtol):
    """max of |got - want| - rtol * |want|: <= atol means allclose."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - rtol * want.abs()).max().item()


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_backward(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    err = {"cell_bwd": 0.0, "conv_same": 0.0}
    times = {"cell_bwd": [0.0, 0.0], "conv_same": [0.0, 0.0]}
    for B, H, W, cin, hid, k in BWD_SHAPES:
        rand = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
        xh32, c, dh, dc = rand(B, H, W, cin), rand(B, H, W, hid), rand(B, H, W, hid), rand(B, H, W, hid)
        w32 = rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5
        b = 0.1 * rand(4 * hid)
        for dtype in (torch.bfloat16, torch.float32):
            xh, w = xh32.to(dtype), w32.to(dtype)
            args = (xh, c, dh, dc, w, b)
            got, again = fused_cell_bwd(*args), fused_cell_bwd(*args)
            want = fused_cell_bwd_plain(*args)
            w_flip = flip_kernel(w)
            dxh, dxh2 = conv_same(want[0], w_flip), conv_same(want[0], w_flip)
            dxh_want = conv_same_plain(want[0], w_flip)
            torch.cuda.synchronize()
            tag = f"B={B} H={H} W={W} Cin={cin} hid={hid} k={k} {str(dtype).split('.')[-1]}"
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"cell_bwd not deterministic at {tag}")
            check(torch.equal(dxh, dxh2), f"conv_same not deterministic at {tag}")
            rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
            d = {
                "dgates": _max_excess(got[0], want[0], rtol),
                "dc_prev": (got[1] - want[1]).abs().max().item(),
                "dw": _rel_max(got[2], want[2]),
                "db": _rel_max(got[3], want[3]),
                "dxh": _rel_max(dxh, dxh_want),
            }
            print(f"[f] {tag}: dgates |d|-{rtol:g}|ref| max {d['dgates']:.3e} "
                  f"(<= 1e-5), |d dc_prev| {d['dc_prev']:.3e}, rel max |d dw| "
                  f"{d['dw']:.3e}, |d db| {d['db']:.3e}, |d dxh| {d['dxh']:.3e} "
                  f"(bounds {BWD_BOUNDS}); bit-identical reruns")
            check(d["dgates"] <= 1e-5, f"dgates {d['dgates']:.3e} at {tag}")
            for name, bound in BWD_BOUNDS.items():
                check(d[name] <= bound, f"{name} {d[name]:.3e} > {bound:g} at {tag}")
            err["cell_bwd"] = max(err["cell_bwd"], *(
                (x.float() - y.float()).abs().max().item() for x, y in zip(got, want)))
            err["conv_same"] = max(err["conv_same"], (dxh - dxh_want).abs().max().item())
            if dtype == torch.bfloat16 and (H, W) == PADDED:
                ms = [cuda_ms(lambda: fused_cell_bwd(*args), 5),
                      cuda_ms(lambda: fused_cell_bwd_plain(*args), 5),
                      cuda_ms(lambda: conv_same(want[0], w_flip), 5),
                      cuda_ms(lambda: conv_same_plain(want[0], w_flip), 5)]
                print(f"[f] {tag}: cell_bwd kernel {ms[0]:.4f} ms, plain "
                      f"{ms[1]:.4f} ms; conv_same kernel {ms[2]:.4f} ms, plain "
                      f"{ms[3]:.4f} ms")
                times["cell_bwd"][0] += ms[0]
                times["cell_bwd"][1] += ms[1]
                times["conv_same"][0] += ms[2]
                times["conv_same"][1] += ms[3]
    for name, (ms, plain_ms) in times.items():
        print(f"[f] {name}, the three training layers, bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    return {name: {"max_abs_err": err[name], "ms": times[name][0],
                   "plain_ms": times[name][1]} for name in err}


def _counts():
    return (convlstm_cell.launches, convgrad.cell_bwd_launches,
            convgrad.conv_same_launches)


def _set_counts(n: int) -> None:
    convlstm_cell.launches = n
    convgrad.cell_bwd_launches = n
    convgrad.conv_same_launches = n


def _train_run(step, params, n_steps, order):
    """n_steps optimizer steps on the windows of ``order``; returns the
    seconds (host clock, synchronised) and the last metrics."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(n_steps):
        _, metrics = step(params, None, order[s * TRAIN_BS : (s + 1) * TRAIN_BS])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def phase_train(device) -> dict:
    data = synthetic_e33oma_90d(T=720, H=GRID[0], W=GRID[1], seed=SEED)
    ds = SequenceDataset(data, period="train", sequence_length=TRAIN_T,
                         in_channels=TRAIN_C)
    static = data["static"][: TRAIN_C - 5]
    kw = dict(in_channels=TRAIN_C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
              compute_dtype="bfloat16")
    bundle = build_model("LSTM-smoke", **kw)
    plain = build_model("LSTM-smoke", cell_fn=fused_cell_forward_plain,
                        grads_fn=cell_grads_plain, **kw)
    params, _ = bundle.init(torch.Generator().manual_seed(SEED), device)
    params_p = _copy_params(params)
    src = DeviceWindowSource(ds, device)
    geo = dict(padded_shape=PADDED, grid_shape=GRID, static=static)
    order = np.random.default_rng(SEED).permutation(src.n)

    def make_step(b, p):
        return make_device_train_step(
            b, ds.normalizer, make_optimizer(p, 1e-3, (0.5, 0.999)), src, **geo)

    step, step_p = make_step(bundle, params), make_step(plain, params_p)
    # parameter gradients at T=GRAD_T against eager autograd through the
    # plain cell, from the same weights and batch, before any update
    x_raw, y_raw = src.gather(order[:TRAIN_BS])
    for dtype in ("bfloat16", "float32"):
        kw_d = dict(kw, compute_dtype=dtype)
        x, y = _device_preprocess(
            x_raw[:, :GRAD_T], y_raw, ds.normalizer, PADDED,
            torch.as_tensor(zscore_static(static), device=device))
        grads = []
        for b, cudnn in ((build_model("LSTM-smoke", **kw_d), True),
                         (build_model("LSTM-smoke", cell_fn=fused_cell_forward_plain,
                                      grads_fn=None, **kw_d), False)):
            # the eager oracle runs without cuDNN, whose f32 weight gradient
            # is off by ~1.6e-2 of its largest entry at layer 1 (PERF.md)
            with torch.backends.cudnn.flags(enabled=cudnn):
                loss, _ = make_loss_fn(b, GRID)(params, None, x, y)
                grads.append(torch.autograd.grad(loss, param_leaves(params)))
            del loss
        rel = [((g - p).norm() / p.norm()).item() for g, p in zip(*grads)]
        print(f"[g] T={GRAD_T} {dtype}: per-leaf |g_kernel - g_eager| / "
              f"|g_eager| max {max(rel):.3e} (tol {TOL_GRAD[dtype]:g}); "
              f"leaves {[f'{r:.1e}' for r in rel]}")
        check(max(rel) <= TOL_GRAD[dtype], f"{dtype} gradients {max(rel):.3e}")
        del grads
        torch.cuda.empty_cache()

    # warm-up step (allocator growth, kernel library load), then the counted run
    _train_run(step, params, 1, order)
    _train_run(step_p, params_p, 1, order)
    _set_counts(0)
    t_kernel, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
    launches = _counts()
    want = len(HIDDEN) * TRAIN_T * TRAIN_STEPS
    print(f"[g] {TRAIN_STEPS} training steps (bs {TRAIN_BS}, T {TRAIN_T}, bf16): "
          f"launches B1/B2/B3 = {launches} (want {want} each); loss "
          f"{metrics['loss'].item():.5f}, R2 {metrics['r2'].item():.4f}")
    check(launches == (want,) * 3, f"launches {launches}, want {want} each")
    check(bool(torch.isfinite(metrics["loss"])), "non-finite loss")
    check(all(bool(torch.isfinite(t).all()) for t in param_leaves(params)),
          "non-finite parameters")
    t_plain, metrics_p = _train_run(step_p, params_p, TRAIN_STEPS, order[TRAIN_BS:])
    check(bool(torch.isfinite(metrics_p["loss"])), "non-finite plain-path loss")
    print(f"[g] plain path, same steps: loss {metrics_p['loss'].item():.5f}")
    phase_cli(device)
    return {"launches": want, "t_kernel": t_kernel, "t_plain": t_plain}


def _copy_params(params):
    return {
        "cells": [{k: v.detach().clone().requires_grad_(True) for k, v in c.items()}
                  for c in params["cells"]],
        "head": {k: v.detach().clone().requires_grad_(True)
                 for k, v in params["head"].items()},
    }


def phase_cli(device) -> None:
    """One epoch of ``python -m nasa_niswan_tpu_torch.train``'s main on a
    small fixture, at the canonical widths."""
    root = tempfile.mkdtemp(prefix="niswan_smoke_")
    try:
        cfg = TrainConfig(
            model="LSTM-smoke", in_channels=TRAIN_C, num_epochs=1, batch_size=4,
            sequence_length=8, synthetic_steps=160, synthetic_grid=(32, 48),
            input_size=(40, 56), compute_dtype="bfloat16", checkpoint_every=1,
            snapshot_dir=os.path.join(root, "snap"), device=str(device),
        )
        cfg.dump()
        out = train_cli.main(cfg)
        with open(os.path.join(cfg.snapshot_dir, "logger.npy"), "rb") as f:
            logs = [np.load(f) for _ in range(3)]
        check(all(a.shape == (1,) and np.isfinite(a).all() for a in logs),
              f"logger.npy {logs}")
        loaded, opt_state, meta = load_checkpoint(
            os.path.join(cfg.snapshot_dir, "epoch-001"), out["params"])
        check(meta["epoch"] == 1 and opt_state["step"] > 0, f"checkpoint meta {meta}")
        check(all(torch.equal(a, b) for a, b in zip(
            param_leaves(loaded), param_leaves(out["params"]))),
            "checkpoint params differ from the trained ones")
        print(f"[g] CLI main: 1 epoch, {opt_state['step']} steps, logger.npy "
              f"{[float(a[0]) for a in logs]}, epoch-001 checkpoint loads back")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    cell = phase_kernel_vs_plain(device)
    serve = phase_serve(device)

    n_steps = N_REQUESTS * STEPS
    for name, t in (("kernel", serve["t_kernel"]), ("plain", serve["t_plain"])):
        print(
            f"[e] {name} path: {model_days_per_min(n_steps, t):.2f} model-days/min, "
            f"{1000 * t / n_steps:.4f} ms/step over {n_steps} steps "
            f"(C={C}, B=1, bf16) on {smi}"
        )
    bwd = phase_backward(device)
    train = phase_train(device)
    for name in ("kernel", "plain"):
        t = train[f"t_{name}"]
        days = TRAIN_STEPS * TRAIN_BS * TRAIN_T / 48.0
        print(
            f"[h] training, {name} path: {1000 * t / TRAIN_STEPS:.1f} ms/step, "
            f"{days / (t / 60.0):.2f} model-days/min over {TRAIN_STEPS} steps "
            f"(bs {TRAIN_BS}, T {TRAIN_T}, C={TRAIN_C}, bf16) on {smi}"
        )
    stats = {
        "convlstm_cell": dict(cell, launches=serve["launches"] + train["launches"]),
        "cell_bwd": dict(bwd["cell_bwd"], launches=train["launches"]),
        "conv_same": dict(bwd["conv_same"], launches=train["launches"]),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": stats[name]["launches"],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, replaces) in KERNEL_SOURCES.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
