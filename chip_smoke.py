#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Drives the port's serving path (``nasa_niswan_tpu_torch``) once at full
width and checks it; imports nothing of JAX or of the JAX package.  Phases,
each printing its own lines:

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
  (e) time: the sustained rate of (d), kernel and plain path (informational).

Then one JSON line describing each kernel, and last the device line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  It also exits non-zero when no CUDA
device is visible.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
from nasa_niswan_tpu_torch.ops import _build, convlstm_cell
from nasa_niswan_tpu_torch.ops.convlstm_cell import (
    fused_cell_forward,
    fused_cell_forward_plain,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    make_rollout_fn,
    make_streaming_rollout,
    model_days_per_min,
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

KERNEL_SOURCE = "nasa_niswan_tpu_torch/csrc/convlstm_cell.cu"
KERNEL_REPLACES = "nasa_niswan_tpu/ops/convlstm_pallas2.py:176"


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
    print(json.dumps({"kernels": [{
        "name": "convlstm_cell",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": serve["launches"],
        "max_abs_err": cell["max_abs_err"],
        "ms": cell["ms"],
        "plain_ms": cell["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
