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
      runs bit-identical; every bf16 shape planned on the wgmma mainloop
      (``cell_plan``); kernel, plain and bound times per shape (CUDA
      events);
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
      and f32, with the bounds in BWD_BOUNDS; B3 alone also at config #3's
      layer 1 (Cout 70); B2's dW
      kernels on their own (conv_dw) at every dW shape of the main paths
      (DW_SHAPES), bf16, each on the tensor-core plan; B2's gate recompute
      (a) alone (``cell_bwd_recompute``), bit-identical to B2's own dgates,
      dc_prev and db, on the wgmma mainloop; two runs bit-identical; per
      shape kernel, plain, library and bound times (CUDA events);
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
      and plain path (informational), and the step's peak device memory;
  (i) B1's emit_gates and xg modes against their plain versions: emit_gates
      at the three training layer shapes (B=8), xg at serving layer 0 (B=1,
      the hoisted h-conv) and at training layer 0 with both modes on; gates
      within one bf16 step plus 1e-5, h' and c' <= 1e-3, reruns
      bit-identical; every bf16 shape on the wgmma mainloop; kernel, plain
      and bound times per shape; the plain mode at the remat step's three
      layers (B=8) and emit_gates at config #3's layer 1 (Cin 70) against
      their plain versions, timed beside them; and the plain mode's time at
      the serving shapes beside (c)'s;
  (j) the per-cell route (remat off) on the canonical training step: 3
      steps with exact launch counts (B1 emit_gates 3 x 48 per step, B2 and
      B1 plain none, B3 3 x 48 - 1 per step: layer 0's first step has no
      input gradient, B2's dW kernels 3 x 48), finite loss; T=8 gradients vs
      eager autograd with (g)'s bounds; ms/step and peak memory beside (h)'s;
  (k) the hoisted input conv: four C=62 serving requests with
      precompute_input_conv against the unhoisted kernel path (RMS <= 2e-2 of
      the std, as (d)) with exact launch counts, ms/step beside (e)'s; the
      device time per serving step with the hoist off and on (profiler
      kernel sum, in turns), the reading behind make_rollout_fn's default;
      one counted training step with the hoist (after a warm-up), and a T=8
      training gradient check with the hoist against eager autograd;
  (l) config #3 (seq2seq scheduled sampling) at full width: in_channels 6,
      hidden 64/32/16, kernels 5/3/3, bf16, bs 8, T 48, 100x154, on
      synthetic_e33oma_90d: 2 steps of each route (per-cell and whole-chunk
      BPTT) from the same weights and draws, with exact launch counts and
      losses agreeing within 1e-5 at step 1 and TOL_S2S_STEP2 at step 2;
      T=8 gradients of each route vs eager autograd; a 48-step closed-loop
      chunk chained through its carry (equal to two 24-step chunks, and
      against the plain path); one CLI epoch of ``--mode seq2seq``;
      fit_seq2seq end to end on both routes (two epochs of 7 steps, batches
      streamed by async_batches: exact launch counts, every batch tensor
      copied from pinned memory on a side stream), ms/step, split on the
      host clock into set-up, first-batch waits, later waits and steps;
  (m) config #2 (20-level fusion, C = 62) from netCDF: a packed
      E33OMA-90Days-style netCDF3 file (T 192, u/v/omega on 20 levels,
      ~0.8 GB) written with write_nc and read back by load_90days_nc
      bit-equal, through the native reader (a scipy fallback fails); fused
      to 62 channels; 3 counted steps of the remat and per-cell routes (bs
      8, T 48, bf16) and their T=8 gradients against eager autograd; B1
      (plain, emit_gates), B2's gate recompute (a), dW and B3 alone at
      layer 1's 126 channels, B = 8, against their plain versions with
      (c)'s, (i)'s and (f)'s tolerances, with kernel, plain, library and
      bound times; one CLI epoch with ``--data-path <file>.nc --levels 20``;
  (n) streamed training: the canonical 8-channel step from a daily netCDF
      tree (90 x 144, 3 days of 48 steps, 3 static channels) through
      LazyE33OMASequence and fit(device_resident=False): exact launch
      counts, every batch tensor copied from pinned memory on a side
      stream (the pipeline's counters, and a profiler trace of two steps
      that puts the copies on a stream that runs none of the step's
      kernels), the batches in batch_iterator's order, losses, R^2 and
      weights equal to the same batches fed synchronously (bit-equal);
      streamed and staged ms/step and host_input_wait_frac.

Then one JSON line describing each kernel (launches summed over the counted
main-path runs, a launch with two modes on counted once; the largest error
against the plain version, kernel, plain and library times, and the least
time the card could take for the same work; the three B1 entries and the
conv_same entry a row per timed shape under "by_shape"; the cell_bwd entry
the same for B2's dW kernels launched on their own, under "dw", and for its
gate recompute (a) alone, under "recompute", each with rows under
"by_shape"; (m)'s rows at 126 channels join them), and last the
device line ``{"ok": true, "device": {...}}``.  Any failed check raises:
the script exits non-zero and prints no result.  It
also exits non-zero when no CUDA device is visible.
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

from nasa_niswan_tpu_torch.data import ncio_native, pipeline
from nasa_niswan_tpu_torch.data.dataset import (
    Normalizer,
    Seq2SeqDataset,
    SequenceDataset,
    preprocess_batch,
    zscore_static,
)
from nasa_niswan_tpu_torch.data.fusion import fuse_levels
from nasa_niswan_tpu_torch.data.ncfixture import write_fixture_tree, write_static_attrs_inputs
from nasa_niswan_tpu_torch.data.ncio import write_nc
from nasa_niswan_tpu_torch.data.netcdf import (
    LazyE33OMASequence,
    build_static_attrs,
    load_90days_nc,
)
from nasa_niswan_tpu_torch.data.pipeline import async_batches, batch_iterator
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
from nasa_niswan_tpu_torch.evalx.evaluate import (
    make_closed_loop_chunk,
    zero_closed_loop_state,
)
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.ops import _build, convgrad, convlstm_cell
from nasa_niswan_tpu_torch.ops.conv import conv2d
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
    fused_cell_gates,
    fused_cell_gates_plain,
)
from nasa_niswan_tpu_torch.rollout import seq2seq as seq2seq_mod
from nasa_niswan_tpu_torch.rollout.seq2seq import (
    _make_forward_chunk,
    fit_seq2seq,
    make_seq2seq_train_step,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    make_rollout_fn,
    make_streaming_rollout,
    model_days_per_min,
)
from nasa_niswan_tpu_torch.train import __main__ as train_cli
from nasa_niswan_tpu_torch.train import loop as train_loop
from nasa_niswan_tpu_torch.train.checkpoint import load_checkpoint, param_leaves
from nasa_niswan_tpu_torch.train.config import TrainConfig
from nasa_niswan_tpu_torch.train.loop import (
    DeviceWindowSource,
    fit,
    make_device_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
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

# config #3: seq2seq scheduled sampling (5 forcings + the feedback channel)
S2S_C = 6
S2S_STEPS = 2
# relative |d loss| of config #3's two routes after one update (1.3e-7
# measured on an H100): far below what a wrong or missing update moves
TOL_S2S_STEP2 = 1e-4
# fit_seq2seq timing: the fixture repeated S2S_REPEAT times gives
# S2S_FIT_STEPS steps an epoch
S2S_REPEAT, S2S_FIT_STEPS = 6, 7

# (B, H, W, Cin, N, k) of every dW launch shape on the main paths: the
# three per-cell training layers, config #3's layer 1 (Cin 70, a ragged
# channel count), the hoisted layer 0's h-conv, and the hoisted input conv
# over all T*B frames
DW_SHAPES = (
    (TRAIN_BS, 100, 154, TRAIN_C + 64, 256, 5),
    (TRAIN_BS, 100, 154, 64 + 32, 128, 3),
    (TRAIN_BS, 100, 154, 32 + 16, 64, 3),
    (TRAIN_BS, 100, 154, S2S_C + 64, 256, 5),
    (TRAIN_BS, 100, 154, 64, 256, 5),
    (TRAIN_T * TRAIN_BS, 100, 154, TRAIN_C, 256, 5),
)

# (B, H, W, Cin, Cout, k) of B3 as a data gradient beyond the three
# training layers: config #3's layer 1 (Cout 70), on dgates of hidden 64;
# config #2's layer 1 (Cout 126) is held in (m)
B3_SHAPES = ((TRAIN_BS, 100, 154, 256, S2S_C + 64, 5),)

# config #2 (20-level fusion) training: layer 1 reads C + 64 = 126 channels
C2_LAYER1 = (TRAIN_BS, 100, 154, C + 64, HIDDEN[0], KERNELS[0])
C2_T = 192  # steps in the packed netCDF file: 134 training windows of 48

KERNEL_SOURCES = {
    "convlstm_cell": ("nasa_niswan_tpu_torch/csrc/convlstm_cell.cu",
                      "nasa_niswan_tpu/ops/convlstm_pallas2.py:176 (plain mode), "
                      "nasa_niswan_tpu/ops/convlstm_pallas.py:52"),
    "convlstm_cell_gates": ("nasa_niswan_tpu_torch/csrc/convlstm_cell.cu",
                            "nasa_niswan_tpu/ops/convlstm_pallas2.py:176 (emit_gates)"),
    "convlstm_cell_xg": ("nasa_niswan_tpu_torch/csrc/convlstm_cell.cu",
                         "nasa_niswan_tpu/ops/convlstm_pallas2.py:176 (xg)"),
    "cell_bwd": ("nasa_niswan_tpu_torch/csrc/cell_bwd.cu",
                 "nasa_niswan_tpu/ops/convgrad_pallas.py:127"),
    "conv_same": ("nasa_niswan_tpu_torch/csrc/conv_same.cu",
                  "nasa_niswan_tpu/ops/convgrad_pallas.py:57"),
}
# published H100 SXM peaks: dense bf16 tensor cores, FP32 pipes, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_S = 3.35e12


def least_time(flops: float, nbytes: float, dtype=torch.bfloat16):
    """(ms, "operations" or "bytes"): the larger of the two least times."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cell_work(B, H, W, cin, hid, k, *, gates=False, xg=False, isz=2):
    """(FLOPs, bytes) of one fused cell step: the gate conv's products,
    each input read once and each output written once."""
    px = B * H * W
    flops = 2.0 * px * k * k * cin * 4 * hid
    nbytes = px * cin * isz + k * k * cin * 4 * hid * isz + 16 * hid  # xh, w, b
    nbytes += 3 * px * hid * 4  # c in, h' and c' out
    nbytes += (px * 4 * hid * isz) * (int(gates) + int(xg))
    return flops, nbytes


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def check_wgmma(shape, tag: str) -> str:
    """A bf16 shape of the cell kernels (every B1 mode, B2's gate
    recompute) must be planned on the wgmma mainloop."""
    plan = convlstm_cell.cell_plan(torch.bfloat16, *shape)
    check(plan == "wgmma", f"{tag}: bf16 {shape} planned on {plan}, not wgmma")
    return plan


def _row(shape, ms, plain_ms, work, **extra) -> dict:
    """One timed shape of a kernel entry: ms, plain ms and the bound."""
    bound_ms, bound_by = least_time(*work)
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **extra}


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
    log = lib_path.with_suffix(".log").read_text().splitlines()
    for line in log:
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[b] {line.strip()}")
    serialized = [line for line in log if "wgmma.mma_async instructions are serialized" in line]
    print(f"[b] ptxas serialized the wgmma pipeline in {len(serialized)} kernels")


def phase_kernel_vs_plain(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err, ms_step, plain_ms_step, by_shape, rows = 0.0, 0.0, 0.0, {}, []
    for B, H, W, cin, hid, k in CELL_SHAPES:
        plan = check_wgmma((B, H, W, cin, hid, k), "[c]")
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
            bound = least_time(*cell_work(B, H, W, cin, hid, k))
            print(
                f"[c] B={B} H={H} W={W} Cin={cin} hid={hid} k={k} "
                f"{str(dtype).split('.')[-1]}: max|dh|={dh:.3e} max|dc|={dc:.3e} "
                f"(tol {TOL_CELL:g}), bit-identical reruns; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                + (f", bound {bound[0]:.4f} ms, {plan} mainloop"
                   if dtype == torch.bfloat16 else "")
            )
            check(dh <= TOL_CELL and dc <= TOL_CELL,
                  f"kernel vs plain {dh:.3e}/{dc:.3e} > {TOL_CELL:g}")
            max_err = max(max_err, dh, dc)
            if dtype == torch.bfloat16 and H == PADDED[0] and W == PADDED[1]:
                ms_step += ms
                plain_ms_step += plain_ms
                by_shape[(B, H, W, cin, hid, k)] = ms
                rows.append(_row((B, H, W, cin, hid, k), ms, plain_ms,
                                 cell_work(B, H, W, cin, hid, k), plan=plan,
                                 launches_per_step="1 per serving step"))
    print(
        f"[c] one serving step's three cells, bf16: kernel {ms_step:.4f} ms, "
        f"plain {plain_ms_step:.4f} ms"
    )
    works = [cell_work(*shape) for shape in by_shape]
    bound_ms, bound_by = least_time(sum(f for f, _ in works), sum(b for _, b in works))
    return {"max_abs_err": max_err, "ms": ms_step, "plain_ms": plain_ms_step,
            "ms_by_shape": by_shape, "by_shape": rows, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
    _set_counts(0)
    t0 = time.perf_counter()
    state, preds = None, []
    for f in forcings:
        p, state = rollout(params, f, state)
        preds.append(p)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = _expect_counts(
        "[d] serving", convlstm_cell=len(HIDDEN) * N_REQUESTS * STEPS)
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
    return {"launches": launches, "t_kernel": t_kernel, "t_plain": t_plain,
            "cfg": cfg, "params": params, "norm": norm, "forcings": forcings,
            "preds": preds}


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
    work = {"cell_bwd": [0.0, 0.0], "conv_same": [0.0, 0.0]}
    library_ms = 0.0
    b3_rows = []  # B3 per shape: the three training layers, then B3_SHAPES
    rec_rows, rec_err = [], 0.0  # B2 (a) alone, per training layer
    for B, H, W, cin, hid, k in BWD_SHAPES:
        check_wgmma((B, H, W, cin, hid, k), "[f] cell_bwd")
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
                      cuda_ms(lambda: conv_same_plain(want[0], w_flip), 5),
                      # the one PyTorch call computing B3's function (bf16 out)
                      cuda_ms(lambda: conv2d(want[0], w_flip, padding=k // 2), 5)]
                print(f"[f] {tag}: cell_bwd kernel {ms[0]:.4f} ms, plain "
                      f"{ms[1]:.4f} ms; conv_same kernel {ms[2]:.4f} ms, plain "
                      f"{ms[3]:.4f} ms, library (bf16 F.conv2d) {ms[4]:.4f} ms")
                times["cell_bwd"][0] += ms[0]
                times["cell_bwd"][1] += ms[1]
                times["conv_same"][0] += ms[2]
                times["conv_same"][1] += ms[3]
                library_ms += ms[4]
                # B2: the gate recompute and dW, two products of the conv's
                # size; in: xh, c, dh, dc, w, b; out: dgates, dc_prev, dw, db
                px, kk = B * H * W, k * k * cin * 4 * hid
                work["cell_bwd"][0] += 2 * 2.0 * px * kk
                work["cell_bwd"][1] += (px * cin * 2 + 3 * px * hid * 4 + kk * 2
                                        + px * 4 * hid * 2 + px * hid * 4 + kk * 4
                                        + 2 * 16 * hid)
                # B3: dgates (B,H,W,4h) bf16 x w' (k,k,4h,Cin) bf16 -> f32
                b3 = conv_work(B, H, W, 4 * hid, cin, k)
                work["conv_same"][0] += b3[0]
                work["conv_same"][1] += b3[1]
                b3_rows.append(_b3_row((B, H, W, 4 * hid, cin, k), d["dxh"], ms[2:], b3))
                rec_rows.append(_recompute_alone(args, got, tag))
    err["conv_same"] = max(err["conv_same"], _b3_alone(device, gen, b3_rows))
    out = {}
    for name, (ms, plain_ms) in times.items():
        print(f"[f] {name}, the three training layers, bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        bound_ms, bound_by = least_time(*work[name])
        out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    out["conv_same"]["library_ms"] = library_ms
    out["conv_same"]["by_shape"] = b3_rows
    print(f"[f] conv_same, the three training layers: library (bf16 F.conv2d) "
          f"{library_ms:.4f} ms")
    out["cell_bwd"]["dw"] = phase_dw(device)
    out["cell_bwd"]["recompute"] = _recompute_entry(rec_rows)
    return out


def recompute_work(B, H, W, cin, hid, k):
    """(FLOPs, bytes) of B2's part (a): the gate conv; in xh, w, b, c, dh,
    dc; out dgates (bf16), dc_prev and one db."""
    px, kk = B * H * W, k * k * cin * 4 * hid
    return 2.0 * px * kk, (px * cin * 2 + kk * 2 + 16 * hid + 4 * px * hid * 4
                           + px * 4 * hid * 2 + 16 * hid)


def _recompute_alone(args, got, tag, tag0="[f]") -> dict:
    """(f) B2's gate recompute (a) alone (``cell_bwd_recompute``, no dW) at
    a training layer, bf16: bit-identical to B2's own dgates, dc_prev and
    db; its largest error against its plain version, and kernel, plain and
    bound times."""
    xh, c = args[0], args[1]
    rec = convgrad.cell_bwd_recompute(*args)
    want = convgrad.cell_bwd_recompute_plain(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(rec, (got[0], got[1], got[3]))),
          f"B2 (a) alone differs from B2 at {tag}")
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(rec, want))
    ms = cuda_ms(lambda: convgrad.cell_bwd_recompute(*args), 5)
    plain_ms = cuda_ms(lambda: convgrad.cell_bwd_recompute_plain(*args), 5)
    shape = (*xh.shape, c.shape[-1], args[4].shape[0])
    row = _row(shape, ms, plain_ms, recompute_work(*shape), plan="wgmma", max_abs_err=err,
               launches_per_step=f"{TRAIN_T} per remat step (one per B2 launch)")
    print(f"{tag0} cell_bwd (a) alone, {tag}: bit-identical to B2's dgates, dc_prev, db; "
          f"max |d| vs plain {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms")
    return row


def _recompute_entry(rows) -> dict:
    """The three training layers of B2 (a) alone, summed."""
    bound_ms, bound_by = least_time(*(sum(v) for v in zip(*(
        recompute_work(*r["shape"]) for r in rows))))
    ms = sum(r["ms"] for r in rows)
    print(f"[f] cell_bwd (a) alone, the three training layers, bf16: kernel {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms")
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "ms": ms,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "by_shape": rows}


def conv_work(B, H, W, cin, cout, k):
    """(FLOPs, bytes) of B3 with bf16 operands: x and w read once, the f32
    output written once."""
    px, kk = B * H * W, k * k * cin * cout
    return 2.0 * px * kk, px * cin * 2 + kk * 2 + px * cout * 4


def _b3_row(shape, rel, ms, work) -> dict:
    bound_ms, bound_by = least_time(*work)
    return {"shape": list(shape), "rel_err": rel, "ms": ms[0], "plain_ms": ms[1],
            "library_ms": ms[2], "bound_ms": bound_ms, "bound_by": bound_by}


def _b3_alone(device, gen, rows, shapes=B3_SHAPES, tag0="[f]", **extra) -> float:
    """B3 alone at ``shapes``, bf16: against the plain version within
    BWD_BOUNDS["dxh"] of the largest entry, reruns bit-identical; kernel,
    plain, library (bf16 F.conv2d) and bound times.  Appends to ``rows``
    (with ``extra``); returns the largest |error|."""
    err = 0.0
    for B, H, W, cin, cout, k in shapes:
        x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
        w = (torch.randn((k, k, cin, cout), generator=gen, device=device)
             / (k * k * cin) ** 0.5).bfloat16()
        got, again, want = conv_same(x, w), conv_same(x, w), conv_same_plain(x, w)
        torch.cuda.synchronize()
        tag = f"B={B} H={H} W={W} Cin={cin} Cout={cout} k={k} bfloat16"
        check(torch.equal(got, again), f"conv_same not deterministic at {tag}")
        rel = _rel_max(got, want)
        check(rel <= BWD_BOUNDS["dxh"], f"conv_same {rel:.3e} at {tag}")
        err = max(err, (got - want).abs().max().item())
        ms = [cuda_ms(lambda: conv_same(x, w), 5), cuda_ms(lambda: conv_same_plain(x, w), 5),
              cuda_ms(lambda: conv2d(x, w, padding=k // 2), 5)]
        row = _b3_row((B, H, W, cin, cout, k), rel, ms, conv_work(B, H, W, cin, cout, k))
        rows.append(dict(row, **extra))
        print(f"{tag0} conv_same {tag}: rel max |d| {rel:.3e} (<= {BWD_BOUNDS['dxh']:g}), "
              f"bit-identical reruns; kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, library "
              f"(bf16 F.conv2d) {ms[2]:.4f} ms, bound {row['bound_ms']:.4f} ms")
        del x, w, got, again, want
    torch.cuda.empty_cache()
    return err


def _dw_alone(device, gen, shape, tag0="[f]", **extra) -> dict:
    """B2's dW kernels on their own (``conv_dw``) at one shape, bf16, on
    the tensor-core plan, against one f32 matmul per tap: relative to the
    largest entry <= BWD_BOUNDS["dw"], reruns bit-identical.  The shape's
    row: error, kernel, plain, library (cuDNN's bf16 weight gradient) and
    bound times, with ``extra``."""
    B, H, W, cin, n, k = shape
    check(convgrad.dw_uses_mma(torch.bfloat16, B, H, W, cin, n, k),
          f"conv_dw at {shape} bf16 is not on the tensor cores")
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    g = torch.randn((B, H, W, n), generator=gen, device=device).bfloat16()
    got, again = convgrad.conv_dw(x, g, k), convgrad.conv_dw(x, g, k)
    want = convlstm_cell.dw_per_tap(x, g, k)
    torch.cuda.synchronize()
    tag = f"B={B} H={H} W={W} Cin={cin} N={n} k={k} bfloat16"
    check(torch.equal(got, again), f"conv_dw not deterministic at {tag}")
    rel = _rel_max(got, want)
    err = (got - want).abs().max().item()
    del again
    # the one PyTorch call computing the same function (bf16 out)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    reps = 3 if B > TRAIN_BS else 5
    ms = [cuda_ms(lambda: convgrad.conv_dw(x, g, k), reps),
          cuda_ms(lambda: convlstm_cell.dw_per_tap(x, g, k), reps),
          cuda_ms(lambda: torch.nn.grad.conv2d_weight(
              xn, (n, cin, k, k), gn, padding=k // 2), reps)]
    # in: x and dgates bf16, out: dw f32
    px, kk = B * H * W, k * k * cin * n
    flops, nbytes = 2.0 * px * kk, px * cin * 2 + px * n * 2 + kk * 4
    bound = least_time(flops, nbytes)
    print(f"{tag0} conv_dw {tag}: tensor-core plan; rel max |d dw| {rel:.3e} (<= "
          f"{BWD_BOUNDS['dw']:g}), bit-identical reruns; kernel {ms[0]:.4f} ms, "
          f"plain {ms[1]:.4f} ms, library (bf16 conv2d_weight) {ms[2]:.4f} ms, "
          f"bound {bound[0]:.4f} ms")
    check(rel <= BWD_BOUNDS["dw"], f"conv_dw {rel:.3e} at {tag}")
    del x, g, got, want
    torch.cuda.empty_cache()
    return {"shape": list(shape), "rel_err": rel, "max_abs_err": err, "ms": ms[0],
            "plain_ms": ms[1], "library_ms": ms[2], "bound_ms": bound[0],
            "bound_by": bound[1], "flops": flops, "bytes": nbytes, **extra}


def phase_dw(device) -> dict:
    """(f) B2's dW kernels on their own (``conv_dw``, the per-cell and
    hoisted routes' weight gradient) at every dW shape of the main paths
    (DW_SHAPES), as ``_dw_alone``; per-shape rows under ``by_shape``, the
    entry's sums over the three training layers."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = [_dw_alone(device, gen, shape) for shape in DW_SHAPES]
    err = max(r.pop("max_abs_err") for r in rows)
    sums = [sum(r[key] for r in rows[:3]) for key in ("ms", "plain_ms", "library_ms")]
    work = [sum(r[key] for r in rows[:3]) for key in ("flops", "bytes")]
    for r in rows:
        del r["flops"], r["bytes"]
    bound_ms, bound_by = least_time(*work)
    print(f"[f] conv_dw, the three training layers, bf16: kernel {sums[0]:.4f} ms, "
          f"plain {sums[1]:.4f} ms, library {sums[2]:.4f} ms, bound {bound_ms:.4f} ms")
    return {"max_abs_err": err, "ms": sums[0], "plain_ms": sums[1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sums[2],
            "by_shape": rows}


COUNTERS = {
    "convlstm_cell": (convlstm_cell, "launches"),
    "convlstm_cell_gates": (convlstm_cell, "gates_launches"),
    "convlstm_cell_xg": (convlstm_cell, "xg_launches"),
    "cell_bwd": (convgrad, "cell_bwd_launches"),
    "conv_same": (convgrad, "conv_same_launches"),
    "conv_dw": (convgrad, "dw_launches"),  # B2's dW kernels on their own
}
# launches of each kernel summed over the counted main-path runs
LAUNCHED = dict.fromkeys(COUNTERS, 0)


def _counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def _set_counts(n: int) -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, n)


def _expect_counts(tag: str, **want) -> dict:
    """Read the counts of the main-path run that began at ``_set_counts(0)``:
    each kernel named in ``want`` exactly that often (> 0), every other
    kernel never.  Adds them to LAUNCHED."""
    got = _counts()
    want = {name: want.get(name, 0) for name in COUNTERS}
    print(f"{tag}: launches {got} (want {want})")
    check(got == want, f"{tag}: launches {got}, want {want}")
    check(all(v > 0 for v in want.values() if v), f"{tag}: a kernel of the path ran no time")
    for name, n in got.items():
        LAUNCHED[name] += n
    return got


COPY_COUNTERS = ("h2d_copies", "h2d_pinned", "h2d_side_stream")


def _reset_copies() -> None:
    for name in COPY_COUNTERS:
        setattr(pipeline, name, 0)


def _copies() -> tuple:
    """(batch tensors copied to the card, from pinned memory, on a side
    stream) since ``_reset_copies``."""
    return tuple(getattr(pipeline, name) for name in COPY_COUNTERS)


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
    init = _copy_params(params)
    # parameter gradients at T=GRAD_T against eager autograd through the
    # plain cell, from the same weights and batch, before any update
    x_raw, y_raw = src.gather(order[:TRAIN_BS])
    x, y = preprocess_batch(
        x_raw[:, :GRAD_T], y_raw, ds.normalizer, PADDED,
        torch.as_tensor(zscore_static(static), device=device))
    grad_check("[g] remat route", params, lambda dtype, eager: make_loss_fn(
        build_model("LSTM-smoke", **dict(kw, compute_dtype=dtype),
                    **(EAGER if eager else {})), GRID)(params, None, x, y)[0])

    # warm-up step (allocator growth, kernel library load), then the counted run
    _train_run(step, params, 1, order)
    _train_run(step_p, params_p, 1, order)
    torch.cuda.reset_peak_memory_stats()
    _set_counts(0)
    t_kernel, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
    want = len(HIDDEN) * TRAIN_T * TRAIN_STEPS
    _expect_counts("[g] remat route", convlstm_cell=want, cell_bwd=want, conv_same=want)
    peak = torch.cuda.max_memory_allocated()
    print(f"[g] {TRAIN_STEPS} training steps (bs {TRAIN_BS}, T {TRAIN_T}, bf16): "
          f"loss {metrics['loss'].item():.5f}, R2 {metrics['r2'].item():.4f}, "
          f"peak memory {peak / 2**30:.2f} GiB")
    check(bool(torch.isfinite(metrics["loss"])), "non-finite loss")
    check(all(bool(torch.isfinite(t).all()) for t in param_leaves(params)),
          "non-finite parameters")
    t_plain, metrics_p = _train_run(step_p, params_p, TRAIN_STEPS, order[TRAIN_BS:])
    check(bool(torch.isfinite(metrics_p["loss"])), "non-finite plain-path loss")
    print(f"[g] plain path, same steps: loss {metrics_p['loss'].item():.5f}")
    phase_cli(device)
    return {"t_kernel": t_kernel, "t_plain": t_plain, "peak": peak, "init": init,
            "kw": kw, "src": src, "ds": ds, "geo": geo, "order": order,
            "xy": (x, y), "make_step": make_step}


# the eager oracle: autograd through the plain cell, no whole-scan BPTT
EAGER = dict(cell_fn=fused_cell_forward_plain, grads_fn=None)


def grad_check(tag, params, loss_of, dtypes=("bfloat16", "float32")) -> None:
    """Parameter gradients of ``loss_of(dtype, eager=False)`` (the kernel
    path) against ``loss_of(dtype, eager=True)`` (eager autograd through the
    plain cell), per leaf relative to the eager gradient's norm (TOL_GRAD).
    The eager oracle runs without cuDNN, whose f32 weight gradient is off by
    ~1.6e-2 of its largest entry at layer 1 (PERF.md)."""
    for dtype in dtypes:
        grads = []
        for eager in (False, True):
            with torch.backends.cudnn.flags(enabled=not eager):
                loss = loss_of(dtype, eager)
                grads.append(torch.autograd.grad(loss, param_leaves(params)))
            del loss
        rel = [((g - p).norm() / p.norm()).item() for g, p in zip(*grads)]
        print(f"{tag}: T={GRAD_T} {dtype}: per-leaf |g_kernel - g_eager| / "
              f"|g_eager| max {max(rel):.3e} (tol {TOL_GRAD[dtype]:g}); "
              f"leaves {[f'{r:.1e}' for r in rel]}")
        check(max(rel) <= TOL_GRAD[dtype], f"{tag} {dtype} gradients {max(rel):.3e}")
        del grads
        torch.cuda.empty_cache()


def phase_modes(device, cell) -> dict:
    """(i) B1's emit_gates and xg modes against their plain versions."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    serve_l0 = (1, PADDED[0], PADDED[1], HIDDEN[0], HIDDEN[0], KERNELS[0])
    train_l0 = (TRAIN_BS, PADDED[0], PADDED[1], HIDDEN[0], HIDDEN[0], KERNELS[0])
    # (mode, shape): emit_gates at the training layers; xg alone at serving
    # layer 0 (the hoisted h-conv); both at training layer 0
    cases = [("gates", sh) for sh in BWD_SHAPES[:3]]
    cases += [("xg", serve_l0), ("gates+xg", train_l0)]
    # per entry: max |err|, then over its timed shapes kernel ms, plain ms,
    # FLOPs and bytes
    stats = {"gates": [0.0] * 5, "xg": [0.0] * 5}
    rows = {"gates": [], "xg": []}
    for mode, (B, H, W, cin, hid, k) in cases:
        plan = check_wgmma((B, H, W, cin, hid, k), f"[i] {mode}")
        xh32, c = rand(B, H, W, cin), rand(B, H, W, hid)
        w32 = rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5
        b, xg32 = 0.1 * rand(4 * hid), rand(B, H, W, 4 * hid)
        for dtype in (torch.bfloat16, torch.float32):
            xh, w = xh32.to(dtype), w32.to(dtype)
            xg = xg32.to(dtype) if "xg" in mode else None
            if mode == "xg":  # the serving launch: no gate output
                fn = lambda: fused_cell_forward(xh, c, w, b, xg)  # noqa: E731
                plain = lambda: fused_cell_forward_plain(xh, c, w, b, xg)  # noqa: E731
            else:
                fn = lambda: fused_cell_gates(xh, c, w, b, xg)  # noqa: E731
                plain = lambda: fused_cell_gates_plain(xh, c, w, b, xg)  # noqa: E731
            with torch.no_grad():
                got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            tag = (f"B={B} H={H} W={W} Cin={cin} hid={hid} k={k} "
                   f"{str(dtype).split('.')[-1]} {mode}")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"{tag}: reruns differ")
            err = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
            line = f"[i] {tag}: max|dh|={err[0]:.3e} max|dc|={err[1]:.3e}"
            check(max(err[:2]) <= TOL_CELL, f"{tag}: h/c {err[:2]}")
            if len(got) == 3:
                check(got[2].dtype == dtype, f"{tag}: gates dtype {got[2].dtype}")
                rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
                excess = _max_excess(got[2], want[2], rtol)
                line += f", gates |d|-{rtol:g}|ref| max {excess:.3e} (<= 1e-5)"
                check(excess <= 1e-5, f"{tag}: gates excess {excess:.3e}")
            if dtype == torch.bfloat16:
                ms, plain_ms = cuda_ms(fn, 10), cuda_ms(plain, 10)
                work = cell_work(B, H, W, cin, hid, k, gates="gates" in mode,
                                 xg="xg" in mode)
                row = _row((B, H, W, cin, hid, k), ms, plain_ms, work, plan=plan, mode=mode,
                           launches_per_step=("1 per hoisted serving step" if mode == "xg"
                                              else f"{TRAIN_T} per per-cell step"))
                rows["xg" if mode == "xg" else "gates"].append(row)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                         f"{row['bound_ms']:.4f} ms, {plan} mainloop")
                if mode in stats:  # the entry's timed shapes
                    flops, nbytes = cell_work(B, H, W, cin, hid, k, gates=mode == "gates",
                                              xg=mode == "xg")
                    for i, v in enumerate((ms, plain_ms, flops, nbytes), start=1):
                        stats[mode][i] += v
            # a launch with both modes on counts under emit_gates
            entry = "xg" if mode == "xg" else "gates"
            stats[entry][0] = max(stats[entry][0], *err)
            print(line + "; bit-identical reruns")
    out = {}
    for name, key in (("gates", "convlstm_cell_gates"), ("xg", "convlstm_cell_xg")):
        err, ms, plain_ms, flops, nbytes = stats[name]
        bound_ms, bound_by = least_time(flops, nbytes)
        out[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "by_shape": rows[name]}
    print(f"[i] emit_gates, the three training layers (B={TRAIN_BS}), bf16: kernel "
          f"{out['convlstm_cell_gates']['ms']:.4f} ms, plain "
          f"{out['convlstm_cell_gates']['plain_ms']:.4f} ms; xg, serving layer 0: "
          f"kernel {out['convlstm_cell_xg']['ms']:.4f} ms, plain "
          f"{out['convlstm_cell_xg']['plain_ms']:.4f} ms")
    # the plain mode at the remat step's layers and emit_gates at config
    # #3's layer 1 (Cin 70), with their plain versions' times
    entries = dict(out, convlstm_cell=cell)
    for shape in BWD_SHAPES[:3]:
        _cell_alone(device, gen, entries, shape, "[i]",
                    {"plain": f"{TRAIN_T} per remat step"}, modes=("plain",))
    _cell_alone(device, gen, entries, (TRAIN_BS, *PADDED, S2S_C + HIDDEN[0], HIDDEN[0],
                                       KERNELS[0]),
                "[i]", {"gates": f"{TRAIN_T} per config #3 per-cell step"}, modes=("gates",))
    # the plain mode reads no xg and writes no gates: its time as in (c)
    for shape, ms_c in cell["ms_by_shape"].items():
        B, H, W, cin, hid, k = shape
        xh, c, b = rand(B, H, W, cin).bfloat16(), rand(B, H, W, hid), rand(4 * hid)
        w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_cell_forward(xh, c, w, b))
        print(f"[i] plain mode, serving Cin={cin} hid={hid} k={k}: {ms:.4f} ms "
              f"(c: {ms_c:.4f} ms)")
    return out


def phase_per_cell(device, train) -> dict:
    """(j) the per-cell route (remat off) on the canonical training step."""
    kw, order = train["kw"], train["order"]
    bundle = build_model("LSTM-smoke", remat=False, **kw)
    params = _copy_params(train["init"])
    step = train["make_step"](bundle, params)
    _train_run(step, params, 1, order)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _set_counts(0)
    t, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
    n = len(HIDDEN) * TRAIN_T * TRAIN_STEPS
    # layer 0's first step has an input that needs no gradient: no B3 there
    _expect_counts("[j] per-cell route", convlstm_cell_gates=n,
                   conv_same=n - TRAIN_STEPS, conv_dw=n)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(metrics["loss"])), "non-finite per-cell loss")
    check(all(bool(torch.isfinite(p).all()) for p in param_leaves(params)),
          "non-finite per-cell parameters")
    print(f"[j] {TRAIN_STEPS} steps (bs {TRAIN_BS}, T {TRAIN_T}, bf16): loss "
          f"{metrics['loss'].item():.5f}; {1000 * t / TRAIN_STEPS:.1f} ms/step "
          f"(remat route, (h): {1000 * train['t_kernel'] / TRAIN_STEPS:.1f}), "
          f"peak memory {peak / 2**30:.2f} GiB (remat route: "
          f"{train['peak'] / 2**30:.2f} GiB)")
    x, y = train["xy"]
    grad_check("[j] per-cell route", params, lambda dtype, eager: make_loss_fn(
        build_model("LSTM-smoke", remat=False, **dict(kw, compute_dtype=dtype),
                    **(EAGER if eager else {})), GRID)(params, None, x, y)[0])
    return {"t": t, "peak": peak}


def phase_hoist(device, serve, train, smi) -> dict:
    """(k) the hoisted input conv, serving and training."""
    cfg, params, norm = serve["cfg"], serve["params"], serve["norm"]
    rollout = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID,
                              device=device, precompute_input_conv=True)
    rollout(params, serve["forcings"][0])  # warm-up
    torch.cuda.synchronize()
    _set_counts(0)
    t0 = time.perf_counter()
    state, preds = None, []
    for f in serve["forcings"]:
        p, state = rollout(params, f, state)
        preds.append(p)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    n = N_REQUESTS * STEPS
    # one hoisted conv (B3) per request
    _expect_counts("[k] hoisted serving", convlstm_cell=(len(HIDDEN) - 1) * n,
                   convlstm_cell_xg=n, conv_same=N_REQUESTS)
    worst = 0.0
    for p, ref in zip(preds, serve["preds"]):
        check(bool(torch.isfinite(p).all()), "non-finite hoisted prediction")
        worst = max(worst, rel_err(p, ref)[1])
    print(f"[k] hoisted vs unhoisted kernel path, {N_REQUESTS} requests: rms/std max "
          f"{worst:.3e} (tol {TOL_PLAIN_REL:g}); {1000 * t / n:.4f} ms/step "
          f"(unhoisted, (e): {1000 * serve['t_kernel'] / n:.4f}) on {smi}")
    check(worst <= TOL_PLAIN_REL, f"hoisted vs unhoisted rms/std {worst:.3e}")
    _hoist_device_time(device, serve, smi)

    # one counted training step with the hoist, then gradients vs eager
    kw, order = train["kw"], train["order"]
    bundle = build_model("LSTM-smoke", precompute_input_conv=True, **kw)
    p_train = _copy_params(train["init"])
    step = train["make_step"](bundle, p_train)
    _train_run(step, p_train, 1, order)  # warm-up
    _set_counts(0)
    t_step, metrics = _train_run(step, p_train, 1, order[TRAIN_BS:])
    m = len(HIDDEN) * TRAIN_T
    # layer 0's launches run xg and emit_gates at once and count under
    # emit_gates; layer 0's first step needs no input gradient; the hoisted
    # conv is one more B3 launch and its weight gradient one more dW launch
    _expect_counts("[k] hoisted training step", convlstm_cell_gates=m,
                   conv_same=m, conv_dw=m + 1)
    check(bool(torch.isfinite(metrics["loss"])), "non-finite hoisted loss")
    print(f"[k] hoisted training step: {1000 * t_step:.1f} ms/step (remat route, "
          f"(h): {1000 * train['t_kernel'] / TRAIN_STEPS:.1f}), loss "
          f"{metrics['loss'].item():.5f}")
    x, y = train["xy"]
    grad_check("[k] hoisted route", p_train, lambda dtype, eager: make_loss_fn(
        build_model("LSTM-smoke", precompute_input_conv=True,
                    **dict(kw, compute_dtype=dtype), **(EAGER if eager else {})),
        GRID)(p_train, None, x, y)[0])
    return {"t": t}


def _request_device_ms(rollout, params, forcings) -> float:
    """Device time per step of one request: the sum of the kernels' device
    time under torch.profiler, after a warm-up request."""
    rollout(params, forcings)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rollout(params, forcings)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / forcings.shape[1]


def _hoist_device_time(device, serve, smi) -> None:
    """(k) the reading behind ``make_rollout_fn(precompute_input_conv=None)``:
    device time per serving step (C = 62, B = 1, bf16, one 48-step request)
    with the hoist off and on, in turns (off, on, on, off)."""
    cfg, params, norm = serve["cfg"], serve["params"], serve["norm"]
    ms = {False: [], True: []}
    for hoist in (False, True, True, False):
        rollout = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID,
                                  device=device, precompute_input_conv=hoist)
        ms[hoist].append(_request_device_ms(rollout, params, serve["forcings"][0]))
    check(all(v > 0 for v in ms[False] + ms[True]), f"[k] no device time profiled: {ms}")
    print(f"[k] serving device time (profiler kernel sum, one {STEPS}-step request each, in "
          f"turns): unhoisted {ms[False]} ms/step, hoisted {ms[True]} ms/step; "
          f"precompute_input_conv=None is off on {smi}")


def phase_seq2seq(device, smi) -> dict:
    """(l) config #3 at full width: both training routes, the closed loop,
    one CLI epoch."""
    data = synthetic_e33oma_90d(T=720, H=GRID[0], W=GRID[1], seed=SEED)
    ds = Seq2SeqDataset(data, period="train", sequence_length=TRAIN_T)
    cfg = ConvLSTMConfig(in_channels=S2S_C, hidden_channels=HIDDEN,
                         kernel_sizes=KERNELS, compute_dtype="bfloat16")
    init = convlstm_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    init = _copy_params(init)
    rng = np.random.default_rng(SEED)
    batches = []
    for s in range(S2S_STEPS + 1):  # the first is the warm-up's
        items = [ds[(s + i) % len(ds)] for i in range(TRAIN_BS)]
        xs, p0s, ys = (torch.as_tensor(np.stack(a), device=device) for a in zip(*items))
        batches.append((xs, p0s, ys, rng.random((TRAIN_T, TRAIN_BS)) < 0.5, 0.5))
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    n = len(HIDDEN) * TRAIN_T * S2S_STEPS
    want = {False: dict(convlstm_cell_gates=n, conv_same=n - S2S_STEPS, conv_dw=n),
            True: dict(convlstm_cell=n, cell_bwd=n, conv_same=n)}
    losses, times = {}, {}
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg, remat=remat)
        for warm in (True, False):
            params = _copy_params(init)
            step = make_seq2seq_train_step(
                rcfg, ds.normalizer, make_optimizer(params, 1e-3, (0.5, 0.999)),
                external_draws=True, **geo)
            run = batches[:1] if warm else batches[1:]
            torch.cuda.synchronize()
            _set_counts(0)
            t0 = time.perf_counter()
            ls = [step(params, *b)["loss"].item() for b in run]
            times[remat] = time.perf_counter() - t0
        route = "whole-chunk BPTT" if remat else "per-cell"
        _expect_counts(f"[l] {route} route", **want[remat])
        losses[remat] = ls
        check(all(np.isfinite(ls)), f"[l] {route}: non-finite loss {ls}")
        print(f"[l] {route} route: losses {ls}, "
              f"{1000 * times[remat] / S2S_STEPS:.1f} ms/step (bs {TRAIN_BS}, T {TRAIN_T}, "
              f"C={S2S_C}, bf16) on {smi}")
    d = [abs(a - b) / abs(b) for a, b in zip(losses[False], losses[True])]
    print(f"[l] per-cell vs whole-chunk BPTT losses: relative |d| {d} (step 1 <= "
          f"1e-5: the same forward; step 2 <= {TOL_S2S_STEP2:g}: bf16 rounds the "
          f"gradients at other places in the two routes)")
    check(d[0] <= 1e-5 and d[1] <= TOL_S2S_STEP2, f"[l] route losses differ: {d}")

    # T=8 gradients of each route against eager autograd (same draws)
    xs, p0s, ys, draws, tp = batches[1]
    params = _copy_params(init)
    for remat in (False, True):
        def loss_of(dtype, eager, remat=remat):
            rcfg = dataclasses.replace(cfg, compute_dtype=dtype, remat=remat and not eager)
            chunk = _make_forward_chunk(rcfg, ds.normalizer, external_draws=True,
                                        **(EAGER if eager else {}), **geo)
            return chunk(params, xs[:, :GRAD_T], p0s, ys[:, :GRAD_T], draws[:GRAD_T], tp)[0]
        grad_check(f"[l] {'whole-chunk BPTT' if remat else 'per-cell'} route", params,
                   loss_of)

    # a 48-step closed-loop chunk chained through its carry, B = 1
    frames, prev0, _ = ds.continuous_stream()
    frames = torch.as_tensor(frames[: 2 * TRAIN_T], device=device)
    prev_n = torch.as_tensor(ds.normalizer.normalize_y(prev0), device=device)[None].float()
    run = make_closed_loop_chunk(cfg, ds.normalizer, **geo)
    run_plain = make_closed_loop_chunk(cfg, ds.normalizer, cell_fn=fused_cell_forward_plain, **geo)
    zero = zero_closed_loop_state(cfg, PADDED, device)
    run(init, zero, prev_n, frames[:TRAIN_T])  # warm-up
    torch.cuda.synchronize()
    _set_counts(0)
    t0 = time.perf_counter()
    st1, fb1, p1 = run(init, zero, prev_n, frames[:TRAIN_T])
    st2, fb2, p2 = run(init, st1, fb1, frames[TRAIN_T:])
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    _expect_counts("[l] closed loop", convlstm_cell=len(HIDDEN) * 2 * TRAIN_T)
    for p in (p1, p2):
        check(tuple(p.shape) == (TRAIN_T, *GRID) and bool(torch.isfinite(p).all()),
              f"closed-loop preds {tuple(p.shape)}")
    half = TRAIN_T // 2
    sa, fa, pa = run(init, zero, prev_n, frames[:half])
    _, _, pb = run(init, sa, fa, frames[half:TRAIN_T])
    d_chunk = (torch.cat([pa, pb]) - p1).abs().max().item()
    _, _, q1 = run_plain(init, zero, prev_n, frames[:TRAIN_T])
    _, rms = rel_err(p1, q1)
    print(f"[l] closed loop, 2 x {TRAIN_T} steps chained: {1000 * t_loop / (2 * TRAIN_T):.4f} "
          f"ms/step; one chunk vs two halves max|d| {d_chunk:.3e} (tol {TOL_CHUNK:g}); "
          f"vs the plain path rms/std {rms:.3e} (tol {TOL_PLAIN_REL:g})")
    check(d_chunk <= TOL_CHUNK, "closed loop: chunked != one-shot")
    check(rms <= TOL_PLAIN_REL, f"closed loop vs plain rms/std {rms:.3e}")
    phase_cli(device, mode="seq2seq")
    return {"times": times, "fit": _fit_seq2seq_times(device, smi, cfg, ds, init)}


def _feed_timeline(module):
    """Wrap ``module.async_batches`` so that each epoch's generator records,
    on the host clock, when the loop first asks it for a batch and how long
    each ask waits (the last, the end of the epoch, included).  Returns the
    list of records and a function that undoes the wrap."""
    real, epochs = module.async_batches, []

    def timed(*args, **kwargs):
        rec = {"start": time.perf_counter(), "waits": []}
        epochs.append(rec)
        it = real(*args, **kwargs)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                rec["waits"].append(time.perf_counter() - t0)
                if batch is None:
                    return
                yield batch
        finally:
            it.close()

    module.async_batches = timed
    return epochs, lambda: setattr(module, "async_batches", real)


def _fit_seq2seq_times(device, smi, cfg, ds, init) -> dict:
    """(l) ``fit_seq2seq`` end to end on both routes, its batches streamed
    by ``async_batches`` (pinned buffers, a side stream): two epochs of
    S2S_FIT_STEPS steps over the fixture repeated S2S_REPEAT times, after a
    one-epoch warm-up call, with exact launch counts and every batch tensor
    copied from pinned memory on a side stream.  The call's time is split
    on the host clock into its set-up (until the loop first asks for a
    batch) and, for each epoch, the wait for its first batch, the waits for
    the others and the rest (the steps, the epoch's closing sync).
    (scripts/time_seq2seq_feed.py compares this feed with staged and
    synchronous ones.)"""
    ds_long = Seq2SeqDataset((np.concatenate([ds._xs] * S2S_REPEAT),
                              np.concatenate([ds._y] * S2S_REPEAT)),
                             period="train", sequence_length=TRAIN_T)
    steps = len(ds_long) // TRAIN_BS
    check(steps == S2S_FIT_STEPS, f"[l] {len(ds_long)} chunks: {steps} steps an epoch")
    epochs = 2
    n = len(HIDDEN) * TRAIN_T * steps * epochs
    want = {False: dict(convlstm_cell_gates=n, conv_same=n - steps * epochs, conv_dw=n),
            True: dict(convlstm_cell=n, cell_bwd=n, conv_same=n)}
    out = {}
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg, remat=remat)
        route = "whole-chunk BPTT" if remat else "per-cell"
        kw = dict(padded_shape=PADDED, grid_shape=GRID, batch_size=TRAIN_BS, seed=SEED,
                  verbose=False)
        fit_seq2seq(rcfg, _copy_params(init), ds_long, num_epochs=1, **kw)  # warm-up
        params = _copy_params(init)
        torch.cuda.synchronize()
        _set_counts(0)
        _reset_copies()
        timeline, undo = _feed_timeline(seq2seq_mod)
        try:
            t0 = time.perf_counter()
            _, _, history = fit_seq2seq(rcfg, params, ds_long, num_epochs=epochs, **kw)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            undo()
        _expect_counts(f"[l] fit_seq2seq, {route} route", **want[remat])
        copies = _copies()
        check(copies == (3 * steps * epochs,) * 3,
              f"[l] batch copies (all, pinned, side) {copies}")
        check(len(timeline) == epochs and all(len(r["waits"]) == steps + 1 for r in timeline),
              f"[l] fit_seq2seq asked for {[len(r['waits']) for r in timeline]} batches")
        check(all(np.isfinite(h["loss"]) for h in history), f"[l] fit_seq2seq loss {history}")
        t = t_end - t0
        ends = [r["start"] for r in timeline[1:]] + [t_end]
        split = []
        for r, end in zip(timeline, ends):
            span, first = end - r["start"], r["waits"][0]
            split.append({"span_ms": 1000 * span, "first_wait_ms": 1000 * first,
                          "later_wait_ms": 1000 * sum(r["waits"][1:]),
                          "steady_ms_step": 1000 * (span - first) / steps})
        out[route] = {"ms_step": 1000 * t / (steps * epochs),
                      "setup_ms": 1000 * (timeline[0]["start"] - t0), "epochs": split}
        print(f"[l] fit_seq2seq, {route} route, batches streamed (async_batches): "
              f"{out[route]['ms_step']:.1f} ms/step over {epochs} epochs of {steps} steps, "
              f"{copies[1]} of {copies[0]} batch tensors pinned, {copies[2]} on a side "
              f"stream; losses {[h['loss'] for h in history]} (bs {TRAIN_BS}, T {TRAIN_T}, "
              f"C={S2S_C}, bf16) on {smi}")
        print(f"[l] fit_seq2seq, {route} route, split on the host clock: set-up "
              f"{out[route]['setup_ms']:.1f} ms; per epoch " + "; ".join(
                  f"{e['span_ms']:.1f} ms, first batch waited {e['first_wait_ms']:.1f} ms, "
                  f"later batches {e['later_wait_ms']:.1f} ms, "
                  f"{e['steady_ms_step']:.1f} ms/step without the first wait"
                  for e in split))
    return out


def _packed_config2(root):
    """Write a packed E33OMA-90Days-style netCDF3 file of config #2's
    forcings (u, v, omega on 20 levels, prec, the BCB source and
    concentration) with the port's write_nc; returns its path and the
    arrays written."""
    data = synthetic_e33oma_90d(T=C2_T, nlev=20, H=GRID[0], W=GRID[1], seed=SEED)
    names = ("u", "v", "omega", "prec", "bcb_src", "bcb_conc")
    dims4, dims3 = ("time", "level", "lat", "lon"), ("time", "lat", "lon")
    path = os.path.join(root, "E33OMA-90Days-L20.nc")
    write_nc(path, {"time": C2_T, "level": 20, "lat": GRID[0], "lon": GRID[1]},
             {k: (dims4 if data[k].ndim == 4 else dims3, data[k]) for k in names},
             time_values=np.arange(C2_T) * 0.5)
    return path, {k: data[k] for k in names}


def _cell_alone(device, gen, stats, shape, tag0, launches, modes=("plain", "gates"),
                recompute=None) -> None:
    """B1 in ``modes`` (plain, emit_gates) and, with ``recompute`` (its
    launches), B2's gate recompute (a) alone at ``shape``, bf16, against
    their plain versions with (c)'s, (i)'s and (f)'s tolerances; each row
    (kernel, plain and bound times, ``launches`` per step of the named
    route) joins its entry's ``by_shape``."""
    B, H, W, cin, hid, k = shape
    plan = check_wgmma(shape, tag0)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    xh, c = rand(B, H, W, cin).bfloat16(), rand(B, H, W, hid)
    w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
    b = 0.1 * rand(4 * hid)
    tag = f"B={B} H={H} W={W} Cin={cin} hid={hid} k={k} bfloat16"
    kernels = {"plain": ("convlstm_cell", fused_cell_forward, fused_cell_forward_plain),
               "gates": ("convlstm_cell_gates", fused_cell_gates, fused_cell_gates_plain)}
    for mode in modes:
        name, fn, plain = kernels[mode]
        with torch.no_grad():
            got, again, want = fn(xh, c, w, b), fn(xh, c, w, b), plain(xh, c, w, b)
        torch.cuda.synchronize()
        check(all(torch.equal(g, a) for g, a in zip(got, again)), f"{tag0} {name}: reruns differ")
        err = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
        check(max(err[:2]) <= TOL_CELL, f"{tag0} {name} h/c {err[:2]} at {tag}")
        line = f"{tag0} {name} {tag}: max|dh|={err[0]:.3e} max|dc|={err[1]:.3e}"
        if mode == "gates":
            excess = _max_excess(got[2], want[2], 2.0**-7)
            check(excess <= 1e-5, f"{tag0} gates excess {excess:.3e} at {tag}")
            line += f", gates |d|-2^-7|ref| max {excess:.3e} (<= 1e-5)"
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(xh, c, w, b), 10)
            plain_ms = cuda_ms(lambda: plain(xh, c, w, b), 3)
        row = _row(shape, ms, plain_ms, cell_work(*shape, gates=mode == "gates"), plan=plan,
                   max_abs_err=max(err), launches_per_step=launches[mode])
        stats[name]["by_shape"].append(row)
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], *err)
        print(line + f"; bit-identical reruns; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {plan} mainloop, "
              "library: none")
    if recompute:
        dh, dc = rand(B, H, W, hid), rand(B, H, W, hid)
        args = (xh, c, dh, dc, w, b)
        rec = _recompute_alone(args, fused_cell_bwd(*args), tag, tag0=tag0)
        rec["launches_per_step"] = recompute
        entry = stats["cell_bwd"]["recompute"]
        entry["by_shape"].append(rec)
        entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])
    torch.cuda.empty_cache()


def phase_config2(device, smi, stats) -> dict:
    """(m) config #2 (20-level fusion, C = 62) trained from netCDF at full
    width: a packed netCDF3 file written and read back bit-equal through the
    native reader, fused to 62 channels, 3 counted steps of the remat and
    per-cell routes, T = GRAD_T gradients of both against eager autograd,
    the layer-1 kernels (Cin / Cout 126, B = 8) alone against their plain
    versions, and one CLI epoch with ``--data-path ... --levels 20``."""
    root = tempfile.mkdtemp(prefix="niswan_c2_")
    try:
        t0 = time.perf_counter()
        path, written = _packed_config2(root)
        t_write = time.perf_counter() - t0
        check(ncio_native.available(), "[m] the native netCDF3 reader did not build")
        reads = ncio_native.reads
        t0 = time.perf_counter()
        data = load_90days_nc(path, levels=20)
        t_read = time.perf_counter() - t0
        check(ncio_native.reads == reads + 1,
              "[m] the packed file was not read by the native reader (a scipy fallback)")
        for name, arr in written.items():
            check(data[name].dtype == np.float32 and np.array_equal(data[name], arr),
                  f"[m] {name} read back differs from what was written")
        print(f"[m] wrote {os.path.basename(path)} ({os.path.getsize(path) / 2**30:.3f} GiB: "
              f"u/v/omega {tuple(written['u'].shape)}, prec, bcb_src, bcb_conc) in "
              f"{t_write:.1f} s; load_90days_nc(levels=20) through the native reader in "
              f"{t_read:.2f} s, bit-equal to the written arrays")
        del written
        xs, y = fuse_levels(data, "bcb", levels=20)
        del data
        check(xs.shape == (C2_T, C, *GRID), f"[m] fused stack {xs.shape}")
        ds = SequenceDataset((xs, y), period="train", sequence_length=TRAIN_T)
        src = DeviceWindowSource(ds, device)
        order = np.random.default_rng(SEED).permutation(src.n)
        kw = dict(in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                  compute_dtype="bfloat16")
        init, _ = build_model("LSTM-c2", **kw).init(torch.Generator().manual_seed(SEED), device)
        n = len(HIDDEN) * TRAIN_T * TRAIN_STEPS
        want = {True: dict(convlstm_cell=n, cell_bwd=n, conv_same=n),
                # layer 0's first step needs no input gradient: no B3 there
                False: dict(convlstm_cell_gates=n, conv_same=n - TRAIN_STEPS, conv_dw=n)}
        x_raw, y_raw = src.gather(order[:TRAIN_BS])
        x, yn = preprocess_batch(x_raw[:, :GRAD_T], y_raw, ds.normalizer, PADDED, None)
        times = {}
        for remat in (True, False):
            route = "remat" if remat else "per-cell"
            params = _copy_params(init)
            step = make_device_train_step(
                build_model("LSTM-c2", remat=remat, **kw), ds.normalizer,
                make_optimizer(params, 1e-3, (0.5, 0.999)), src,
                padded_shape=PADDED, grid_shape=GRID)
            _train_run(step, params, 1, order)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            _set_counts(0)
            t, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
            _expect_counts(f"[m] config #2, {route} route", **want[remat])
            peak = torch.cuda.max_memory_allocated()
            check(bool(torch.isfinite(metrics["loss"])), f"[m] {route}: non-finite loss")
            check(all(bool(torch.isfinite(p).all()) for p in param_leaves(params)),
                  f"[m] {route}: non-finite parameters")
            times[route] = t
            print(f"[m] config #2 {route} route, {TRAIN_STEPS} steps (bs {TRAIN_BS}, T "
                  f"{TRAIN_T}, C={C}, bf16): loss {metrics['loss'].item():.5f}, "
                  f"{1000 * t / TRAIN_STEPS:.1f} ms/step, peak memory {peak / 2**30:.2f} GiB "
                  f"on {smi}")
            grad_check(f"[m] config #2, {route} route", params,
                       lambda dtype, eager, remat=remat: make_loss_fn(build_model(
                           "LSTM-c2", remat=remat, **dict(kw, compute_dtype=dtype),
                           **(EAGER if eager else {})), GRID)(params, None, x, yn)[0])
        del src, x, yn, x_raw, y_raw
        torch.cuda.empty_cache()

        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        _cell_alone(device, gen, stats, C2_LAYER1, "[m]", {
            "plain": f"{TRAIN_T} per config #2 remat step",
            "gates": f"{TRAIN_T} per config #2 per-cell step"},
            recompute=f"{TRAIN_T} per config #2 remat step (one per B2 launch)")
        dw_shape = (TRAIN_BS, 100, 154, C + 64, 4 * HIDDEN[0], KERNELS[0])
        row = _dw_alone(device, gen, dw_shape, tag0="[m]",
                        launches_per_step=f"{TRAIN_T} per config #2 per-cell step")
        del row["flops"], row["bytes"]
        dw = stats["cell_bwd"]["dw"]
        dw["max_abs_err"] = max(dw["max_abs_err"], row.pop("max_abs_err"))
        dw["by_shape"].append(row)
        cs = stats["conv_same"]
        cs["max_abs_err"] = max(cs["max_abs_err"], _b3_alone(
            device, gen, cs["by_shape"], shapes=((TRAIN_BS, 100, 154, 4 * HIDDEN[0], C + 64,
                                                  KERNELS[0]),),
            tag0="[m]", launches_per_step=f"{TRAIN_T} per config #2 remat step"))

        phase_cli(device, tag="[m]", data_path=path, levels=20, in_channels=5,
                  batch_size=TRAIN_BS, input_size=PADDED)
        return times
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _trace_streams(run, nbytes, root) -> tuple:
    """The streams of the host-to-device copies of ``nbytes`` bytes, and
    the set of streams that run kernels, in a profiler trace of ``run()``
    (its Chrome trace, written under ``root``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(root, "streams_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies, kernels = [], set()
    for e in events:
        args = e.get("args") or {}
        stream = args.get("stream", e.get("tid"))
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "") \
                and args.get("bytes") in nbytes:
            copies.append(stream)
        elif e.get("cat") == "kernel":
            kernels.add(stream)
    return copies, kernels


def phase_streamed(device, smi) -> dict:
    """(n) the canonical 8-channel step streamed from a daily netCDF tree:
    ``LazyE33OMASequence`` (90 x 144, 3 days of 48 steps, 1 level, 3 static
    channels) through ``fit(device_resident=False)``, with exact launch
    counts, every batch copied from pinned memory on a side stream (the
    pipeline's counters, and a profiler trace that puts the copies on a
    stream other than the step kernels'), the batches in ``batch_iterator``'s
    order, and the epoch's losses, R^2 and
    weights equal to the same batches fed synchronously, bit for bit.  Then
    streamed and staged ms/step of the same step, and the loop's share of
    time waiting on the batch queue (``host_input_wait_frac``, as
    bench.py's main_train defines it)."""
    root = tempfile.mkdtemp(prefix="niswan_tree_")
    try:
        tree = os.path.join(root, "tree")
        write_fixture_tree(tree, days=3, steps_per_day=48, H=GRID[0], W=GRID[1], levels=1,
                           seed=SEED)
        paths = write_static_attrs_inputs(os.path.join(root, "static"), H=GRID[0], W=GRID[1])
        static_path = build_static_attrs(paths["land_cover"], paths["lai"], paths["grid"],
                                         os.path.join(root, "static_attrs.nc"))
        lazy = dict(sequence_length=TRAIN_T, in_channels=TRAIN_C, padding=PADDED,
                    static_attrs_path=static_path)
        train, val = (LazyE33OMASequence(tree, period=p, **lazy) for p in ("train", "val"))
        # the lazy samples come normalized (variable_statistics.json), with
        # the static channels and padded: the step adds nothing
        ident = Normalizer(x_mean=np.zeros(TRAIN_C, np.float32),
                           x_std=np.ones(TRAIN_C, np.float32), y_mean=0.0, y_std=1.0)
        cfg = TrainConfig(model="LSTM-stream", in_channels=TRAIN_C, batch_size=TRAIN_BS,
                          sequence_length=TRAIN_T, num_epochs=1, input_size=None,
                          checkpoint_every=0, compute_dtype="bfloat16",
                          snapshot_dir=os.path.join(root, "snap"), device=str(device))
        bundle = build_model("LSTM-stream", in_channels=TRAIN_C, hidden_channels=HIDDEN,
                             kernel_sizes=KERNELS, compute_dtype="bfloat16")
        init, _ = bundle.init(torch.Generator().manual_seed(SEED), device)
        n_train, n_val = len(train) // TRAIN_BS, -(-len(val) // TRAIN_BS)
        host = list(batch_iterator(train, TRAIN_BS, shuffle=True, seed=cfg.seed, epoch=1))
        check(len(host) == n_train > 0, f"[n] {len(host)} training batches")

        seen, real = [], train_loop.async_batches

        def spy(dataset, *args, **kwargs):
            for batch in real(dataset, *args, **kwargs):
                if dataset is train:
                    seen.append(batch[1].cpu())
                yield batch

        train_loop.async_batches = spy
        params = _copy_params(init)
        _set_counts(0)
        _reset_copies()
        try:
            out = fit(bundle, train, val, cfg, device=device, normalizer=ident,
                      init_params=params, device_resident=False, verbose=False)
        finally:
            train_loop.async_batches = real
        m = len(HIDDEN) * TRAIN_T
        _expect_counts("[n] streamed fit", convlstm_cell=m * (n_train + n_val),
                       cell_bwd=m * n_train, conv_same=m * n_train)
        copies = _copies()
        check(copies == (2 * (n_train + n_val),) * 3,
              f"[n] batch copies (all, pinned, side stream) {copies}")
        check(len(seen) == n_train and all(
            torch.equal(a, torch.from_numpy(b[1])) for a, b in zip(seen, host)),
            "[n] the streamed batches are not batch_iterator's")
        print(f"[n] streamed fit: {n_train} training and {n_val} validation batches from "
              f"{len(train)} + {len(val)} lazy windows; {copies[0]} batch tensors copied, "
              f"{copies[1]} from pinned memory, {copies[2]} on a side stream; batches in "
              f"batch_iterator's order; logger {out['logger']}")

        params_s = _copy_params(init)
        step = make_train_step(bundle, ident, make_optimizer(params_s, cfg.learning_rate,
                                                             tuple(cfg.betas)),
                               padded_shape=None, grid_shape=GRID)
        metrics = [step(params_s, None, *b)[1] for b in host]
        sync = (float(torch.stack([mm["loss"] for mm in metrics]).mean()),
                float(torch.stack([mm["r2"] for mm in metrics]).mean()))
        got = (out["logger"]["MSELoss"][0], out["logger"]["r2_score"][0])
        check(got == sync and all(torch.equal(a, b) for a, b in zip(
            param_leaves(out["params"]), param_leaves(params_s))),
            f"[n] streamed {got} != synchronous {sync}")
        print(f"[n] streamed fit == the same batches fed synchronously: loss {got[0]!r}, "
              f"R2 {got[1]!r}, weights bit-equal")

        # the trace's own witness of the side stream: the batches' host-to-
        # device copies sit on a stream that runs none of the step's kernels
        nbytes = {a.nbytes for a in host[0]}

        def two_steps():
            it = async_batches(train, TRAIN_BS, shuffle=True, seed=cfg.seed, epoch=3,
                               device=device)
            for _, batch in zip(range(2), it):
                step(params_s, None, *batch)
            it.close()

        copy_streams, kernel_streams = _trace_streams(two_steps, nbytes, root)
        check(len(copy_streams) >= 2 * len(host[0]) and kernel_streams
              and not set(copy_streams) & kernel_streams,
              f"[n] traced batch copies on streams {copy_streams}, the step's kernels on "
              f"{sorted(kernel_streams)}")
        print(f"[n] profiler trace of two streamed steps: {len(copy_streams)} batch copies "
              f"(HtoD, {sorted(nbytes)} bytes) on stream(s) {sorted(set(copy_streams))}, "
              f"the step's kernels on stream(s) {sorted(kernel_streams)}")

        # bench.py main_train's loop: the wait on the queue, then the step
        it = async_batches(train, TRAIN_BS, shuffle=True, seed=cfg.seed, epoch=2,
                           device=device)
        torch.cuda.synchronize()
        tic, wait, n = time.perf_counter(), 0.0, 0
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            step(params_s, None, *batch)
            n += 1
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - tic
        staged = [tuple(torch.as_tensor(a, device=device) for a in b) for b in host]
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for b in staged:
            step(params_s, None, *b)
        torch.cuda.synchronize()
        t_staged = time.perf_counter() - tic
        frac = wait / t_stream
        print(f"[n] streamed from the lazy netCDF tree: {1000 * t_stream / n:.1f} ms/step, "
              f"host_input_wait_frac {frac:.4f}; the same batches staged on the card: "
              f"{1000 * t_staged / len(staged):.1f} ms/step ({n} steps, bs {TRAIN_BS}, "
              f"T {TRAIN_T}, C={TRAIN_C}, bf16) on {smi}")
        return {"stream_ms": 1000 * t_stream / n, "staged_ms": 1000 * t_staged / len(staged),
                "host_input_wait_frac": frac}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _copy_params(params):
    return {
        "cells": [{k: v.detach().clone().requires_grad_(True) for k, v in c.items()}
                  for c in params["cells"]],
        "head": {k: v.detach().clone().requires_grad_(True)
                 for k, v in params["head"].items()},
    }


def phase_cli(device, mode: str = "windowed", tag: str = "", **overrides) -> None:
    """One epoch of ``python -m nasa_niswan_tpu_torch.train``'s main at the
    canonical widths, in ``mode``: on a small synthetic fixture, or on what
    ``overrides`` (TrainConfig fields, such as a ``data_path``) name."""
    root = tempfile.mkdtemp(prefix="niswan_smoke_")
    try:
        fields = dict(
            model="LSTM-smoke", in_channels=TRAIN_C if mode == "windowed" else 5,
            num_epochs=1, batch_size=4, mode=mode,
            sequence_length=8, synthetic_steps=160, synthetic_grid=(32, 48),
            input_size=(40, 56), compute_dtype="bfloat16", checkpoint_every=1,
            snapshot_dir=os.path.join(root, "snap"), device=str(device),
        )
        cfg = TrainConfig(**dict(fields, **overrides))
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
        tag = tag or ("[g]" if mode == "windowed" else "[l]")
        src = f"--data-path {os.path.basename(cfg.data_path)} " if cfg.data_path else ""
        print(f"{tag} CLI main {src}--levels {cfg.levels} --mode {mode} (in_channels "
              f"{cfg.in_channels}): 1 epoch, {opt_state['step']} steps, "
              f"logger.npy {[float(a[0]) for a in logs]}, epoch-001 checkpoint "
              "loads back")
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
    print(f"[h] training, kernel path: peak memory {train['peak'] / 2**30:.2f} GiB")
    stats = dict(phase_modes(device, cell), convlstm_cell=cell, **bwd)
    phase_per_cell(device, train)
    phase_hoist(device, serve, train, smi)
    phase_seq2seq(device, smi)
    phase_config2(device, smi, stats)
    phase_streamed(device, smi)
    check(all(LAUNCHED[name] > 0 for name in COUNTERS), f"kernels never launched: {LAUNCHED}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": LAUNCHED[name],
         **{key: stats[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         # B2's dW kernels launched on their own (niswan::conv_dw), and its
         # gate recompute (a) alone, run once in every B2 launch
         **({"dw": dict(launches=LAUNCHED["conv_dw"], **stats[name]["dw"]),
             "recompute": dict(launches=LAUNCHED["cell_bwd"], **stats[name]["recompute"])}
            if name == "cell_bwd" else {}),
         # per timed shape (B3: the three training layers, B3_SHAPES, (m))
         **({"by_shape": stats[name]["by_shape"]} if "by_shape" in stats[name] else {})}
        for name, (src, replaces) in KERNEL_SOURCES.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
