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
      B=1: four 48-step requests chained through the carry, each one CUDA
      graph replay after a warm-up request, with exactly 3 x 4 x 48 kernel
      launches, finite outputs, one 48-step request equal
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
      kernel on its own (conv_dw) at every dW shape of the main paths
      (DW_SHAPES), bf16, each on the wgmma kernel (``dw_wgmma_launches``
      counting each launch), replayed in a CUDA graph too and beside the
      mma.sync kernel it replaced (DW_MMA_SYNC_MS); B2's gate recompute
      (a) alone (``cell_bwd_recompute``), bit-identical to B2's own dgates,
      dc_prev and db, on the wgmma mainloop; two runs bit-identical; per
      shape kernel, plain, library and bound times (CUDA events);
  (g) train: the canonical training step (bs 8, T 48, 8 input channels,
      hidden 64/32/16, kernels 5/3/3, bf16, 100x154, Adam lr 1e-3 betas
      (0.5, 0.999)) on the synthetic fixture (T=720, 90x144, seed 0): one
      warm-up step, then 3 optimizer steps through make_device_train_step
      with exactly 3 x 48 x 3 launches of each of B1, B2, B3 (every B2's dW
      on the wgmma kernel: ``dw_wgmma_launches``), finite loss and
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
      streamed and staged ms/step and host_input_wait_frac;
  (o) serving as CUDA graphs (graph.py; every rollout on the card
      above was one already): (d)'s four chained requests and their carry
      bit-equal to the eager body that is captured, chunked equal to
      one-shot, two hoisted requests, ten streaming steps; after one Adam
      step on a copy of the weights (in place) the next request recaptures
      and equals eager; one request's B1 launches exactly 3 x 48, from the
      runner's counters and from the profiler's kernels by name; the
      sustained rate in bench.py's serving setup (6 chained 384-step chunks,
      best of 3), eager and graph in turns: host-clock ms/step and
      model-days/min, and device ms/step (profiler kernel sum); a request
      served once (48 steps, and the 864-step test period of the 90-day
      dataset): the graph's first call (one-step warm-up, capture, replay)
      beside one eager call and one replay, on the host clock;
  (p) the CLIs on full-width snapshots of seeded weights (save_checkpoint)
      over the synthetic stream (240 steps, 90 x 144): config #2 (C = 62)
      through the evaluation CLI's report, the serving CLI in chunks of 24
      against the same run split by --state-out / --skip --state-in
      (bit-equal, read back from the .nc files), and --artifact from
      export_rollout equal to the live route; config #3's closed loop split
      the same way; C1 on config #2's training split, in a process of its
      own (its launches are not in the kernels line): the allocator capped
      (``set_per_process_memory_fraction``, restored to 1.0 after) so that
      what the process holds plus what streaming took fits and the forcing
      slab does not, the CLI's resident upload refused with
      torch.OutOfMemoryError, its stderr message, its predictions bit-equal
      to --resident-gb 0 and B1 launched as often;
  (x) run right after (p): docs/REALDATA.md's canonical training command
      line (LSTM-5C, bs 8, T 48, 100 x 154, C 5, bf16, --cell-impl auto;
      the synthetic fixture of 240 steps for --data-path, one epoch, a
      checkpoint every epoch) through the port's parse_args and train main:
      B1, B2 and B3 launched, and the same command without --cell-impl
      launching as often, its logger.npy and epoch-001 parameters
      bit-equal;
  (q) S = 3 species at C = 62 as one multi-tracer graph, with exact launch
      counts, bit-equal to three single rollouts; batched OAT against
      serial within (d)'s bf16 bound;
  (r) the single-step families at full width (f32, TF32 off), on the
      synthetic fixture at 90 x 144 padded to 256 x 256: the UNet-5ch
      forward (features 64/128/256/512, ~31.0 M parameters, B = 8) in eval
      and train mode on the card against the CPU (output and new running
      statistics within TOL_R_FWD), its FLOPs per sample and FP32 bound;
      one epoch of ``fit`` on a UNet (bs 8, MSE + L1, Adam lr 1e-3 betas
      (0.5, 0.999)) whose epoch-001 checkpoint, BatchNorm state as s<i>,
      loads back equal, then its step's ms/step, host_input_wait_frac, peak
      memory and the conv kernels' share of the device time (profiler);
      the UNet-6ch closed loop over the 90-day fixture's 864-step test
      split in chunks of 480, graph replays bit-equal to the eager body and
      to ``predict_test_feedback``, its first 8 steps against the CPU loop
      (TOL_R_LOOP), ms/step on the host clock and the device, and a chunk
      served once (eager, first graph call, replay); pix2pix generator
      training (features 64, bs 8, dropout on): ``fit``, ms/step and peak
      memory; one GAN step (generator 64, PatchGAN 64/128/256/512, bs 8):
      losses finite, both networks moved; the evaluation and serving CLIs
      on full-width UNet-6ch and PIX2PIX snapshots of seeded weights over a
      240-step stream (test split 48 steps: depth cut), the serving CLI on
      route ``single_step`` equal to the evaluation's predictions.  No
      kernel of the port runs in (r): its launch counts are read as zero;
  (s) parallel/ on a one-rank NCCL group made in this process (destroyed
      at the end): at (d)'s full width each sharded serving entry point
      (the rollout over (d)'s requests, the per-species multi-tracer
      rollout of (q)'s 3 species, the shared-meteorology one at config
      #5's width C = 5, the closed loop) over two chained 48-step chunks,
      each chunk one CUDA graph replay (halo exchange, B1 on each
      halo-extended tile, the gathers, all captured): exact B1 counts under
      replay, bit-equal to the eager body (``.eager``, the oracle), and
      predictions and carries within TOL_CHUNK of the unsharded graph
      (max |d| over the std; carries absolute; bit-equal expected), the
      replay's, the eager body's and the unsharded graph's ms/step on the
      host clock beside the replay's device time (profiler);
      the data-parallel step on the remat route (``make_device_train_step``
      with the mesh; bs 8, T 48, 3 steps, exact B1/B2/B3 counts) bit-equal
      to the step without it in parameters and loss (an all-reduce over
      one rank is the identity); B1 at the three serving layers on
      (lat, lon) = (1, 1) (the zero-extended 104 x 158 / 102 x 156 frame
      the one-rank path runs), (2, 2) and (2, 7) tiles with halos cut from
      the frame: every tile against the plain cell on its inputs
      (TOL_CELL), and the tiles stitched against B1 on the whole frame
      (bit-equal expected, |d| <= TOL_CELL held), every tile shape on the
      wgmma mainloop; the sum over the tiles of B1's device time
      beside the whole frame's (launches replayed in a CUDA graph, CUDA
      events; eager times beside them); the serving CLI with
      ``--sharded 1 1`` (one rank spawned, NCCL) against the unsharded CLI
      on full-width config #2 and #3 snapshots (max |d| <= TOL_CHUNK of
      the std); config #5's scripts at a size their outputs name:
      scripts/torch_bench_sharded_rollout.py (96 steps),
      torch_run_multitracer_demo.py (SCRIPT_DEMO) and
      torch_run_decadal_rollout.py (SCRIPT_DECADAL) on one device and with
      ``--sharded 1 1``, every number they write finite and the sharded
      decade equal to the unsharded one.  With two cards
      or more a two-rank phase (launch.spawn, NCCL): the (1, 1, 2) sharded
      rollout (a replay with NCCL messages captured) equal to its eager
      body and against the single-device rollout, and the dp = 2 step
      against the one-rank step; with one card it says that phase was not
      run;
  (t) training at scale, on a one-rank NCCL group made in this process
      (destroyed at the end): the canonical step (bs 8, T 48, 8 channels,
      hidden 64/32/16, kernels 5/3/3) through ``make_spatial_train_step``
      on the remat, per-cell and hoisted routes, the tile being the
      zero-extended frame, against the single-device step from the same
      weights and batch: per-leaf gradients within TOL_GRAD of the leaf's
      largest (bf16 at T 48, f32 at T 8), exact launch counts over 3
      counted steps of each, equal between them (the hoist: B1 xg +
      emit_gates, B3, dW), ms/step on the host clock and in device time
      and peak memory beside the single-device step's; the UNet's DP and
      spatially sharded steps (features 64/128/256/512, bs 8, f32, their
      BatchNorm sums all-reduced through NCCL) against the single-device
      step: the gradients in f64, per leaf within TOL_T_UNET of the leaf's
      largest of each other and of the f64 loss gradient (the f32 ones
      printed beside them), the f32 running statistics within TOL_T_UNET
      of each leaf's largest (on one rank the all-reduce is the identity:
      the global statistics across ranks are held by the CPU two-rank
      tests); the pix2pix generator's spatially sharded step (features 64,
      256 x 256) against the single-device step, f64 gradients per leaf
      within TOL_T_UNET; an async checkpoint (train/checkpoint_async.py) of
      the canonical model while steps run, restored bit-equal, ms/step
      with and without it, beside a synchronous ``save_checkpoint`` of the
      same state; B1 (plain and emit_gates), B2, its dW kernels alone and
      B3 on the halo-extended tiles of the (1, 1), (2, 2) and (2, 7) cuts
      at the three training layers (B = 8), each against its plain version
      at (c)'s, (i)'s and (f)'s bounds, with kernel, plain, bound and cuDNN
      times and the tiles summed beside the whole frame; the hoist's B3
      forward and dW over the step's 384 frames (Cin 8 -> 256, k 5) and
      layer 0's B1 xg + emit_gates on the whole frame and those tiles;
      with two cards or more the (1, 1, 2) and (1, 2, 1) sharded steps
      (three routes, the UNet in f64) against the one-rank step (two
      ranks, NCCL); with one card it says that part was not run;
  (u) configs #1-#4's campaigns at full width, cut only in steps and
      epochs (U_RUNS; each run's cut in its printed flags): the north-star
      year (C = 62, B = 1, bf16, 2880 steps from a 1440-step resident
      block in chunks of 480, each a graph replay: exactly 3 x 2880 B1
      launches in the year, the chunk's input copy timed), the train year
      (2880 steps, 2 epochs), the seq2seq protocol (1 epoch of each
      schedule), the year rollout (2880 steps, 10 training days, 1 epoch,
      chunks of 480) and r02 (720 steps, 1 epoch of A and of B), then both examples at
      their defaults (the quickstart with --no-figures; the served chunks
      of the exported artifact against one rollout, 1e-6 of the largest)
      and scripts/torch_multihost_worker.py as one OS process joined
      through env:// on NCCL (WORLD_SIZE 1): its DP step's loss and
      updated parameters bit-equal to make_train_step without a mesh, its
      rollouts within 1e-6; each run's counts read from 0, every number it
      writes finite, B1, B2 and B3 launched where it trains, its start
      under [time]; the two-process worker only with two cards (with one
      card it says it was not run);
  (v) in a process of its own (its launches are not in the kernels line),
      the profiling and benchmark scripts at a cut size (their steps,
      reps, fixture lengths; widths full), each run's counts read from 0:
      scripts/torch_profile_rollout.py (48 steps, every row a graph replay,
      host and device ms/step; a 24-step full_scan replay traced and
      summarized by torch_trace_summary.py: exactly 3 x 24 B1 launches in
      the trace, the share of the bf16 peak in (0, 1]),
      torch_profile_closed_loop.py (48 steps, two chunks chained; its
      traced chunk exactly 3 x 48 B1 launches), torch_profile_seq2seq.py
      (B 4, T 48: both routes and the pad ablation, pad_share finite),
      torch_bench_cell.py (the serving shootout with --parity, the kernel
      within 0.05 of the plain rollout; --train at B 4, T 8),
      torch_bench_ncread.py (8 steps a day: native == scipy) and
      profile_torch_train_step.py (the remat route on a 240-step fixture:
      its traced step exactly 3 x 48 B1 and B2 (a) launches); every time
      finite and positive;
  (w) run right after (h): training as CUDA graphs.  Every training step
      above, (g)-(u), is a graph replay (graph.py), each phase
      printing its eager body's (``step.eager``) ms/step beside the
      replay's; here each step function from one set of weights, 4 calls
      graphed (an eager step and the capture, then replays) against 4
      calls of its eager body, the lr changed before call 3: the remat,
      per-cell and hoisted canonical steps, config #2 (C = 62) and config
      #3 (both routes, draws from a seeded CPU generator) bit-equal in
      parameters, Adam's step and moments, state and metrics; the UNet,
      the pix2pix generator and the GAN step (cuDNN's deterministic
      algorithms selected) within TOL_T_UNET per leaf; one capture each;
      on the remat step an async save before call 3 and a restore before
      call 5 (one recapture), a serving graph captured after call 1 that
      sees the weights of replays 2-4 (the version bump), and one replay
      under the profiler: B1, B2 (a), dW and B3 launches by kernel name
      equal to the runner's counters, each kernel's ms per launch; the
      eval steps bit-equal; the DP step and the sharded remat, per-cell,
      hoisted, UNet and pix2pix steps on a one-rank NCCL group (the
      all-reduce and the halo path captured); per step function replay
      host ms/step, its device span (CUDA events), eager ms/step and peak
      memory; the dp = 2 and (1, 1, 2) replays only with two cards.

Then one JSON line describing each kernel (launches summed over the counted
main-path runs, a launch with two modes on counted once; the largest error
against the plain version, kernel, plain and library times, and the least
time the card could take for the same work; the three B1 entries and the
conv_same entry a row per timed shape under "by_shape"; the cell_bwd entry
the same for B2's dW kernels launched on their own, under "dw", and for its
gate recompute (a) alone, under "recompute", each with rows under
"by_shape"; (m)'s rows at 126 channels and (t)'s tile rows join them, B2's
own tile rows under the cell_bwd entry's "by_shape"), and last the
device line ``{"ok": true, "device": {...}}``.  Any failed check raises:
the script exits non-zero and prints no result.  It
also exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves, tree_map, tree_paths, tree_unflatten
from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data import ncio_native, pipeline
from nasa_niswan_tpu_torch.data.dataset import (
    Normalizer,
    Seq2SeqDataset,
    SequenceDataset,
    SingleStepDataset,
    make_preprocess_fn,
    preprocess_batch,
    zscore_static,
)
from nasa_niswan_tpu_torch.data.fusion import fuse_levels
from nasa_niswan_tpu_torch.data.ncfixture import write_fixture_tree, write_static_attrs_inputs
from nasa_niswan_tpu_torch.data.ncio import open_nc, write_nc
from nasa_niswan_tpu_torch.data.netcdf import (
    LazyE33OMASequence,
    build_static_attrs,
    load_90days_nc,
)
from nasa_niswan_tpu_torch.data.pipeline import async_batches, batch_iterator
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
from nasa_niswan_tpu_torch.evalx import __main__ as eval_cli
from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot
from nasa_niswan_tpu_torch.evalx.evaluate import (
    _run_chunked_episode,
    make_closed_loop_chunk,
    make_feedback_chunk,
    predict_test_feedback,
    zero_closed_loop_state,
)
from nasa_niswan_tpu_torch.graph import optimizer_leaves
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
from nasa_niswan_tpu_torch.models.pix2pix import DiscriminatorConfig, discriminator_init
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
    join_xh,
)
from nasa_niswan_tpu_torch.rollout import seq2seq as seq2seq_mod
from nasa_niswan_tpu_torch.rollout.seq2seq import (
    _make_forward_chunk,
    fit_seq2seq,
    make_seq2seq_train_step,
)
from nasa_niswan_tpu_torch.rollout import __main__ as serve_cli
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    make_rollout_fn,
    make_streaming_rollout,
    model_days_per_min,
)
from nasa_niswan_tpu_torch.rollout.export import export_rollout
from nasa_niswan_tpu_torch.rollout.multitracer import (
    make_multitracer_rollout,
    make_multitracer_rollout_shared,
    stack_params,
)
from nasa_niswan_tpu_torch.rollout.sensitivity import oat_sensitivity
from nasa_niswan_tpu_torch.train import __main__ as train_cli
from nasa_niswan_tpu_torch.train import loop as train_loop
from nasa_niswan_tpu_torch.train.gan import make_gan_train_step
from nasa_niswan_tpu_torch.train.checkpoint import (
    load_checkpoint,
    param_leaves,
    save_checkpoint,
)
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args
from nasa_niswan_tpu_torch.train.loop import (
    DeviceWindowSource,
    fit,
    make_device_train_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    set_learning_rate,
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
# (o) bench.py's serving setup: chunks of 384 steps, 6 chained, best of 3
BENCH_STEPS, BENCH_CHUNKS, BENCH_REPS = 384, 6, 3
# (p) steps of the synthetic stream behind the CLI snapshots: a test split
# of one 48-step window, served in chunks of 24
CLI_T, CLI_CHUNK = 240, 24
N_SPECIES = 3  # (q)
# (o) requests served once: one request, and the test period of the 90-day
# dataset (20% of 90 x 48 steps), as predict_test_rollout serves it
FIRST_CALL_STEPS = (STEPS, 864)

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


def _serving_pair(xh32: torch.Tensor, hid: int, layer: int) -> tuple:
    """A serving cell's input as the main path hands it over: the pair (x,
    h), layer 1's x a bf16 frame in the channels-first layout that
    ``_prep_frame`` leaves (channel stride H*W), a later layer's x the
    previous layer's f32 h', h the f32 carry."""
    cx = xh32.shape[-1] - hid
    x = xh32[..., :cx]
    x = (x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16).permute(0, 2, 3, 1)
         if layer == 0 else x.contiguous())
    return x, xh32[..., cx:].contiguous()


def phase_kernel_vs_plain(device) -> dict:
    """B1's plain mode against the plain version: at the serving shapes in
    bf16 the two-part launch on the pair (x, h) in the main path's layouts
    (timed, bit-equal to the launch on the concatenated xh), else the
    launch on xh."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err, ms_step, plain_ms_step, by_shape, rows = 0.0, 0.0, 0.0, {}, []
    for layer, (B, H, W, cin, hid, k) in enumerate(CELL_SHAPES):
        plan = check_wgmma((B, H, W, cin, hid, k), "[c]")
        xh32 = torch.randn((B, H, W, cin), generator=gen, device=device)
        c = torch.randn((B, H, W, hid), generator=gen, device=device)
        w32 = torch.randn((k, k, cin, 4 * hid), generator=gen, device=device)
        w32 /= (k * k * cin) ** 0.5
        b = 0.1 * torch.randn((4 * hid,), generator=gen, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            main = dtype == torch.bfloat16 and (H, W) == PADDED
            xh = _serving_pair(xh32, hid, layer) if main else xh32.to(dtype)
            w = w32.to(dtype)
            parts = convlstm_cell.parts_launches
            h1, c1 = fused_cell_forward(xh, c, w, b)
            if main:
                check(convlstm_cell.parts_launches == parts + 1,
                      f"[c] {(B, H, W, cin, hid, k)}: the pair did not take the two-part launch")
                h0, c0 = fused_cell_forward(join_xh(xh, dtype), c, w, b)
                check(torch.equal(h1, h0) and torch.equal(c1, c0),
                      f"[c] {(B, H, W, cin, hid, k)}: two-part launch != launch on xh")
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
                f"{str(dtype).split('.')[-1]}"
                f"{' (x, h) two-part, == launch on xh' if main else ''}: "
                f"max|dh|={dh:.3e} max|dc|={dc:.3e} "
                f"(tol {TOL_CELL:g}), bit-identical reruns; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                + (f", bound {bound[0]:.4f} ms, {plan} mainloop"
                   if dtype == torch.bfloat16 else "")
            )
            check(dh <= TOL_CELL and dc <= TOL_CELL,
                  f"kernel vs plain {dh:.3e}/{dc:.3e} > {TOL_CELL:g}")
            max_err = max(max_err, dh, dc)
            if main:
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
        "[d] serving", parts=len(HIDDEN) * N_REQUESTS * STEPS,
        convlstm_cell=len(HIDDEN) * N_REQUESTS * STEPS)
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
            "preds": preds, "state": state, "rollout": rollout}


def rel_err(p: torch.Tensor, ref: torch.Tensor):
    """(max, rms) of |p - ref| over std(ref)."""
    d = (p - ref).abs()
    std = ref.std()
    return (d.max() / std).item(), (d.pow(2).mean().sqrt() / std).item()


def _tree_to(tree, device):
    """A detached copy of a parameter or state tree on ``device``."""
    return tree_map(lambda t: t.detach().to(device), tree)


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
                b2 = cell_bwd_work(B, H, W, cin, hid, k)
                work["cell_bwd"][0] += b2[0]
                work["cell_bwd"][1] += b2[1]
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


def cell_bwd_work(B, H, W, cin, hid, k):
    """(FLOPs, bytes) of B2: the gate recompute and dW, two products of the
    conv's size; in xh, c, dh, dc, w, b; out dgates, dc_prev, dw, db."""
    px, kk = B * H * W, k * k * cin * 4 * hid
    return 2 * 2.0 * px * kk, (px * cin * 2 + 3 * px * hid * 4 + kk * 2 + px * 4 * hid * 2
                               + px * hid * 4 + kk * 4 + 2 * 16 * hid)


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


# ms of one launch of the mma.sync dW kernel that dw_mma_kernel_wgmma
# replaced (PERF.md section 6: eager CUDA events on an H100 at 700 W, PR
# 6-14), at the shapes _dw_alone times
DW_MMA_SYNC_MS = {
    (8, 100, 154, 72, 256, 5): 0.5050, (8, 100, 154, 96, 128, 3): 0.2366,
    (8, 100, 154, 48, 64, 3): 0.1231, (8, 100, 154, 70, 256, 5): 0.5166,
    (8, 100, 154, 64, 256, 5): 0.4185, (384, 100, 154, 8, 256, 5): 4.4490,
    (8, 100, 154, 126, 256, 5): 0.8232,
    (8, 104, 158, 72, 256, 5): 0.5059, (8, 54, 81, 72, 256, 5): 0.1847,
    (8, 54, 26, 72, 256, 5): 0.0901, (8, 102, 156, 96, 128, 3): 0.1577,
    (8, 52, 79, 96, 128, 3): 0.0658, (8, 52, 24, 96, 128, 3): 0.0593,
    (8, 102, 156, 48, 64, 3): 0.0650, (8, 52, 79, 48, 64, 3): 0.0699,
    (8, 52, 24, 48, 64, 3): 0.0811, (384, 104, 158, 8, 256, 5): 4.4537,
    (384, 54, 81, 8, 256, 5): 1.4536, (384, 54, 26, 8, 256, 5): 0.5039,
}


def _dw_alone(device, gen, shape, tag0="[f]", **extra) -> dict:
    """B2's dW kernel on its own (``conv_dw``) at one shape, bf16, on the
    wgmma kernel (each launch counted once in ``dw_wgmma_launches``),
    against one f32 matmul per tap: relative to the largest entry <=
    BWD_BOUNDS["dw"], reruns bit-identical.  The shape's row: error,
    kernel (eager and replayed in a CUDA graph), plain, library (cuDNN's
    bf16 weight gradient) and bound times, with ``extra``; the print puts
    the replaced mma.sync kernel's time (DW_MMA_SYNC_MS, not measured in
    this run) beside them."""
    B, H, W, cin, n, k = shape
    plan = convgrad.dw_plan(torch.bfloat16, B, H, W, cin, n, k)
    check(plan == "wgmma", f"conv_dw at {shape} bf16 planned on {plan}, not wgmma")
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    g = torch.randn((B, H, W, n), generator=gen, device=device).bfloat16()
    n_wgmma = convgrad.dw_wgmma_launches
    got, again = convgrad.conv_dw(x, g, k), convgrad.conv_dw(x, g, k)
    check(convgrad.dw_wgmma_launches == n_wgmma + 2,
          f"conv_dw at {shape}: dw_wgmma_launches {convgrad.dw_wgmma_launches - n_wgmma}, want 2")
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
    replay = graph_ms(lambda: convgrad.conv_dw(x, g, k), n=2 if B > TRAIN_BS else 8, reps=3)
    old = DW_MMA_SYNC_MS.get(tuple(shape))
    # in: x and dgates bf16, out: dw f32
    px, kk = B * H * W, k * k * cin * n
    flops, nbytes = 2.0 * px * kk, px * cin * 2 + px * n * 2 + kk * 4
    bound = least_time(flops, nbytes)
    print(f"{tag0} conv_dw {tag}: wgmma; rel max |d dw| {rel:.3e} (<= "
          f"{BWD_BOUNDS['dw']:g}), bit-identical reruns; kernel {ms[0]:.4f} ms (replayed "
          f"{replay:.4f} ms), the mma.sync kernel it replaced "
          f"{'not measured' if old is None else f'{old:.4f} ms'} (PERF.md), plain "
          f"{ms[1]:.4f} ms, library (bf16 conv2d_weight) {ms[2]:.4f} ms, bound "
          f"{bound[0]:.4f} ms")
    check(rel <= BWD_BOUNDS["dw"], f"conv_dw {rel:.3e} at {tag}")
    del x, g, got, want
    torch.cuda.empty_cache()
    return {"shape": list(shape), "rel_err": rel, "max_abs_err": err, "ms": ms[0],
            "replay_ms": replay, "plain_ms": ms[1],
            "library_ms": ms[2], "bound_ms": bound[0], "bound_by": bound[1], "flops": flops,
            "bytes": nbytes, **extra}


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
    convlstm_cell.parts_launches = n
    convgrad.dw_wgmma_launches = n


def _expect_counts(tag: str, parts=None, dw_wgmma=None, **want) -> dict:
    """Read the counts of the main-path run that began at ``_set_counts(0)``:
    each kernel named in ``want`` exactly that often (> 0), every other
    kernel never; with ``parts``, that many of B1's plain launches staged
    the pair (x, h) (``convlstm_cell.parts_launches``, a sub-count of
    ``launches``); with ``dw_wgmma``, that many dW launches ran the wgmma
    kernel (``convgrad.dw_wgmma_launches``, a sub-count of the dW launches
    in ``cell_bwd`` and ``conv_dw``).  Adds them to LAUNCHED."""
    got = _counts()
    want = {name: want.get(name, 0) for name in COUNTERS}
    print(f"{tag}: launches {got} (want {want})")
    check(got == want, f"{tag}: launches {got}, want {want}")
    if parts is not None:
        n_parts = convlstm_cell.parts_launches
        print(f"{tag}: {n_parts} of them staged the pair (x, h) (want {parts})")
        check(n_parts == parts, f"{tag}: {n_parts} two-part launches, want {parts}")
    if dw_wgmma is not None:
        n_dw = convgrad.dw_wgmma_launches
        print(f"{tag}: {n_dw} dW launches ran the wgmma kernel (want {dw_wgmma})")
        check(n_dw == dw_wgmma, f"{tag}: {n_dw} wgmma dW launches, want {dw_wgmma}")
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


def _event_ms(fn) -> float:
    """The device span of ``fn()`` in ms, between CUDA events around it."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def _host_ms(fn, n: int = 2) -> float:
    """Host-clock ms of ``fn()`` (synchronised), the mean of ``n`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / n


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

    # the first call (an eager step on the capture stream, then the capture:
    # allocator growth, kernel library load), then the counted run of replays;
    # the peak covers both, the capture's private pool included
    torch.cuda.reset_peak_memory_stats()
    _train_run(step, params, 1, order)
    peak_first = torch.cuda.max_memory_allocated()
    _train_run(step_p, params_p, 1, order)
    torch.cuda.reset_peak_memory_stats()
    _set_counts(0)
    t_kernel, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
    want = len(HIDDEN) * TRAIN_T * TRAIN_STEPS
    _expect_counts("[g] remat route", parts=want, dw_wgmma=want, convlstm_cell=want,
                   cell_bwd=want, conv_same=want)
    peak = max(peak_first, torch.cuda.max_memory_allocated())
    print(f"[g] {TRAIN_STEPS} training steps (bs {TRAIN_BS}, T {TRAIN_T}, bf16): "
          f"loss {metrics['loss'].item():.5f}, R2 {metrics['r2'].item():.4f}, "
          f"peak memory {peak / 2**30:.2f} GiB")
    check(bool(torch.isfinite(metrics["loss"])), "non-finite loss")
    check(all(bool(torch.isfinite(t).all()) for t in param_leaves(params)),
          "non-finite parameters")
    t_plain, metrics_p = _train_run(step_p, params_p, TRAIN_STEPS, order[TRAIN_BS:])
    check(bool(torch.isfinite(metrics_p["loss"])), "non-finite plain-path loss")
    print(f"[g] plain path, same steps: loss {metrics_p['loss'].item():.5f}")
    # the eager body of the graphed step, same windows (three more steps)
    t_eager = _train_run(step.eager, params, TRAIN_STEPS, order[TRAIN_BS:])[0]
    phase_cli(device)
    return {"t_kernel": t_kernel, "t_plain": t_plain, "t_eager": t_eager, "peak": peak,
            "init": init,
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
    torch.cuda.reset_peak_memory_stats()
    _train_run(step, params, 1, order)  # warm-up: an eager step, then the capture
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
    t_eager = _train_run(step.eager, params, TRAIN_STEPS, order[TRAIN_BS:])[0]
    print(f"[j] {TRAIN_STEPS} steps (bs {TRAIN_BS}, T {TRAIN_T}, bf16): loss "
          f"{metrics['loss'].item():.5f}; {1000 * t / TRAIN_STEPS:.1f} ms/step graph "
          f"replays, eager body {1000 * t_eager / TRAIN_STEPS:.1f} "
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
    t_eager = _train_run(step.eager, p_train, 1, order[TRAIN_BS:])[0]
    print(f"[k] hoisted training step: {1000 * t_step:.1f} ms/step graph replay, eager "
          f"body {1000 * t_eager:.1f} (remat route, "
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
        replay = _host_ms(lambda: step(params, *batches[1]))
        eager = _host_ms(lambda: step.eager(params, *batches[1]))
        print(f"[l] {route} route: losses {ls}, "
              f"{1000 * times[remat] / S2S_STEPS:.1f} ms/step (the first an eager step and "
              f"the capture); a replay {replay:.1f} ms, the eager body {eager:.1f} ms "
              f"(bs {TRAIN_BS}, T {TRAIN_T}, C={S2S_C}, bf16) on {smi}")
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
                recompute=None, **extra) -> None:
    """B1 in ``modes`` (plain, emit_gates, xg: emit_gates with hoisted
    gates, the hoisted layer 0's launch) and, with ``recompute`` (its
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
    xg = rand(B, H, W, 4 * hid).bfloat16() if "xg" in modes else None
    kernels = {"plain": ("convlstm_cell", fused_cell_forward, fused_cell_forward_plain),
               "gates": ("convlstm_cell_gates", fused_cell_gates, fused_cell_gates_plain),
               # the hoisted layer 0: xg and emit_gates in one launch
               "xg": ("convlstm_cell_gates", lambda *a: fused_cell_gates(*a, xg),
                      lambda *a: fused_cell_gates_plain(*a, xg))}
    for mode in modes:
        name, fn, plain = kernels[mode]
        with torch.no_grad():
            got, again, want = fn(xh, c, w, b), fn(xh, c, w, b), plain(xh, c, w, b)
        torch.cuda.synchronize()
        check(all(torch.equal(g, a) for g, a in zip(got, again)), f"{tag0} {name}: reruns differ")
        err = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
        check(max(err[:2]) <= TOL_CELL, f"{tag0} {name} h/c {err[:2]} at {tag}")
        line = (f"{tag0} {name}{' (xg)' if mode == 'xg' else ''} {tag}: max|dh|={err[0]:.3e} "
                f"max|dc|={err[1]:.3e}")
        if mode != "plain":
            excess = _max_excess(got[2], want[2], 2.0**-7)
            check(excess <= 1e-5, f"{tag0} gates excess {excess:.3e} at {tag}")
            line += f", gates |d|-2^-7|ref| max {excess:.3e} (<= 1e-5)"
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(xh, c, w, b), 10)
            plain_ms = cuda_ms(lambda: plain(xh, c, w, b), 3)
        row = _row(shape, ms, plain_ms,
                   cell_work(*shape, gates=mode != "plain", xg=mode == "xg"), plan=plan,
                   max_abs_err=max(err), launches_per_step=launches[mode], **extra)
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
            torch.cuda.reset_peak_memory_stats()
            _train_run(step, params, 1, order)  # warm-up: an eager step, then the capture
            _set_counts(0)
            t, metrics = _train_run(step, params, TRAIN_STEPS, order[TRAIN_BS:])
            _expect_counts(f"[m] config #2, {route} route", **want[remat])
            peak = torch.cuda.max_memory_allocated()
            check(bool(torch.isfinite(metrics["loss"])), f"[m] {route}: non-finite loss")
            check(all(bool(torch.isfinite(p).all()) for p in param_leaves(params)),
                  f"[m] {route}: non-finite parameters")
            times[route] = t
            eager = _host_ms(lambda: step.eager(params, None, order[:TRAIN_BS]))
            print(f"[m] config #2 {route} route, {TRAIN_STEPS} steps (bs {TRAIN_BS}, T "
                  f"{TRAIN_T}, C={C}, bf16): loss {metrics['loss'].item():.5f}, "
                  f"{1000 * t / TRAIN_STEPS:.1f} ms/step graph replays, eager body "
                  f"{eager:.1f}, peak memory {peak / 2**30:.2f} GiB on {smi}")
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
        eager = _host_ms(lambda: step.eager(params_s, None, *staged[0]))
        frac = wait / t_stream
        print(f"[n] streamed from the lazy netCDF tree: {1000 * t_stream / n:.1f} ms/step, "
              f"host_input_wait_frac {frac:.4f}; the same batches staged on the card: "
              f"{1000 * t_staged / len(staged):.1f} ms/step (graph replays; the eager body "
              f"{eager:.1f}) ({n} steps, bs {TRAIN_BS}, T {TRAIN_T}, C={TRAIN_C}, bf16) "
              f"on {smi}")
        return {"stream_ms": 1000 * t_stream / n, "staged_ms": 1000 * t_staged / len(staged),
                "host_input_wait_frac": frac}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for hc_a, hc_b in zip(a, b) for x, y in zip(hc_a, hc_b))


def _profile(fn):
    """(kernel device time in ms, {kernel name: (launches, device ms)}) of
    ``fn()`` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            {e.key: (e.count, e.self_device_time_total / 1e3) for e in events})


def _serving_rate(device, smi) -> dict:
    """(o) bench.py's serving setup (C = 62, B = 1, bf16, seed 0, zero-mean
    unit-std normalizer, one 384-step forcing chunk served 6 times chained
    through the carry, best of 3 on the host clock, synchronised at the end
    of each chain), eager and graph in turns; then each one's device time
    per step over one chunk under the profiler."""
    cfg = ConvLSTMConfig(in_channels=C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype="bfloat16")
    params = convlstm_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    norm = Normalizer(x_mean=np.zeros(C, np.float32), x_std=np.ones(C, np.float32),
                      y_mean=0.0, y_std=1.0)
    rng = np.random.default_rng(SEED)
    forcings = torch.as_tensor(
        rng.standard_normal((1, BENCH_STEPS, C, *GRID)).astype(np.float32), device=device)
    rollout = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID, device=device)
    fns = {"eager": rollout.eager, "graph": rollout}
    for fn in fns.values():  # warm-up: the fresh and the carried variant
        _, st = fn(params, forcings)
        fn(params, forcings, st)
    torch.cuda.synchronize()
    wall = {name: [] for name in fns}
    n = BENCH_CHUNKS * BENCH_STEPS
    for name in ("eager", "graph", "graph", "eager", "eager", "graph"):
        t0 = time.perf_counter()
        st = None
        for _ in range(BENCH_CHUNKS):
            _, st = fns[name](params, forcings, st)
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    out = {}
    for name, fn in fns.items():
        dev_ms, _ = _profile(lambda: fn(params, forcings))
        best = min(wall[name])
        out[name] = {"ms_step": 1000 * best / n, "model_days_per_min": model_days_per_min(n, best),
                     "device_ms_step": dev_ms / BENCH_STEPS,
                     "runs_ms_step": [1000 * t / n for t in wall[name]]}
        print(f"[o] serving rate, {name}: {out[name]['ms_step']:.4f} ms/step "
              f"(runs {out[name]['runs_ms_step']}), "
              f"{out[name]['model_days_per_min']:.2f} model-days/min on the host clock; "
              f"device {out[name]['device_ms_step']:.4f} ms/step (profiler kernel sum) "
              f"({BENCH_CHUNKS} x {BENCH_STEPS} steps, best of {BENCH_REPS}, C={C}, B=1, "
              f"bf16) on {smi}")
    return out


def _first_call(device, serve, smi) -> dict:
    """(o) what a request served once costs: a fresh rollout's first call
    (warm-up on one step, capture, instantiation, one replay) beside one
    eager call of the same request and one replay, host clock, synchronised
    after each; forcings drawn on the card from the seed."""
    cfg, params, norm = serve["cfg"], serve["params"], serve["norm"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for T in FIRST_CALL_STEPS:
        forcings = torch.randn((1, T, C, *GRID), generator=gen, device=device)
        rollout = make_rollout_fn(cfg, norm, padded_shape=PADDED, grid_shape=GRID,
                                  device=device)
        ms = {}
        for name, fn in (("eager", rollout.eager), ("first_graph_call", rollout),
                         ("replay", rollout)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _ = fn(params, forcings)
            torch.cuda.synchronize()
            ms[name] = 1000 * (time.perf_counter() - t0)
            if name == "eager":
                want = p
            else:
                check(torch.equal(p, want), f"[o] {T}-step request: graph != eager")
        check(rollout.runner.captures == 1, "[o] first-call request captured twice")
        out[T] = ms
        print(f"[o] a {T}-step request served once: eager {ms['eager']:.1f} ms, "
              f"graph first call (one-step warm-up + capture + replay) "
              f"{ms['first_graph_call']:.1f} ms "
              f"({ms['first_graph_call'] / ms['eager']:.2f}x eager), replay "
              f"{ms['replay']:.1f} ms; host clock, C={C}, B=1, bf16, on {smi}")
        del forcings, rollout, p, want
    torch.cuda.empty_cache()
    return out


def phase_graph_serve(device, serve, stats, smi) -> dict:
    """(o) serving replayed as CUDA graphs, at full width, against the
    eager body that is captured; B1's replay times join ``stats``."""
    cfg, params, norm = serve["cfg"], serve["params"], serve["norm"]
    forcings, rollout = serve["forcings"], serve["rollout"]
    kw = dict(padded_shape=PADDED, grid_shape=GRID, device=device)
    # (d)'s four chained requests were graph replays: the eager body gives
    # the same bits
    st = None
    for f, p in zip(forcings, serve["preds"]):
        q, st = rollout.eager(params, f, st)
        check(torch.equal(p, q), "[o] graph request != eager request")
    check(_same_state(serve["state"], st), "[o] graph carry != eager carry")
    half = STEPS // 2
    p_a, s_a = rollout(params, forcings[0][:, :half])
    p_b, s_b = rollout(params, forcings[0][:, half:], s_a)
    p_one, s_one = rollout(params, forcings[0])
    check(torch.equal(torch.cat([p_a, p_b], dim=1), p_one) and _same_state(s_b, s_one),
          "[o] graph: chunked != one-shot")
    hoisted = make_rollout_fn(cfg, norm, precompute_input_conv=True, **kw)
    st_g = st_e = None
    for f in forcings[:2]:
        p_g, st_g = hoisted(params, f, st_g)
        p_e, st_e = hoisted.eager(params, f, st_e)
        check(torch.equal(p_g, p_e) and _same_state(st_g, st_e), "[o] hoisted graph != eager")
    step = make_streaming_rollout(cfg, norm, params, **kw)
    want, st_e = rollout.eager(params, forcings[0][:, :10])
    check(all(torch.equal(step(forcings[0][:, t]), want[:, t]) for t in range(10))
          and _same_state(step.carry(), st_e), "[o] streaming graph != eager")
    print(f"[o] graph replays bit-equal to the eager body: {N_REQUESTS} chained "
          f"{STEPS}-step requests and their carry, chunked vs one-shot, 2 hoisted "
          f"requests, 10 streaming steps; captures: rollout {rollout.runner.captures}, "
          f"hoisted {hoisted.runner.captures}, streaming {step.runner.captures}")

    # an in-place weight change (one Adam step on a copy) between two requests
    moved = _copy_params(params)
    roll2 = make_rollout_fn(cfg, norm, **kw)
    before, _ = roll2(moved, forcings[0])
    leaves = param_leaves(moved)
    for t in leaves:
        t.grad = torch.ones_like(t)
    make_optimizer(moved, 1e-3, (0.5, 0.999)).step()
    after, _ = roll2(moved, forcings[0])
    want, _ = roll2.eager(moved, forcings[0])
    check(torch.equal(after, want) and not torch.equal(after, before)
          and roll2.runner.captures == 2, "[o] graph served stale weights after an update")
    print("[o] after an in-place Adam step on the weights: the next request recaptures "
          "and equals the eager body")

    # exact B1 launch counts of one request: the runner's and the profiler's
    rollout(params, forcings[0])
    torch.cuda.synchronize()
    _set_counts(0)
    _, names = _profile(lambda: rollout(params, forcings[0]))
    _expect_counts("[o] one graph request", convlstm_cell=len(HIDDEN) * STEPS)
    cells = sum(n for k, (n, _) in names.items() if "cell_wgmma_kernel" in k)
    print(f"[o] profiler, one graph request: {cells} cell_wgmma_kernel launches "
          f"(want {len(HIDDEN) * STEPS})")
    check(cells == len(HIDDEN) * STEPS, f"[o] profiler counts {cells} B1 launches")
    # B1's device time per launch under replay, by layer: the kernel's
    # template arguments are (k, hidden / 8)
    replay = {}
    for key, (n, ms) in names.items():
        m = re.search(r"cell_wgmma_kernel<(\d+), ?(\d+)", key)
        if m:
            replay[int(m.group(1)), 8 * int(m.group(2))] = (n, ms / n)
    for row in stats["convlstm_cell"]["by_shape"]:
        B, H, W, cin, hid, k = row["shape"]
        if B == 1 and (k, hid) in replay:
            row["replay_ms"] = replay[k, hid][1]
            print(f"[o] B1 {tuple(row['shape'])} under graph replay: "
                  f"{replay[k, hid][1]:.4f} ms per launch ({replay[k, hid][0]} launches; "
                  f"eager CUDA events, (c): {row['ms']:.4f})")
    if not replay:  # informational: the profiler's names carry no template arguments
        print(f"[o] B1 replay times by layer not read from the kernel names {sorted(names)}")
    _first_call(device, serve, smi)
    return _serving_rate(device, smi)


def _snapshot(root, name, **fields) -> str:
    """A full-width snapshot of seeded weights (save_checkpoint) over the
    synthetic stream: configurations.json + epoch-001/."""
    run_dir = os.path.join(root, name)
    cfg = TrainConfig(model="LSTM-smoke", hidden_channels=HIDDEN, kernel_size=KERNELS,
                      num_layers=len(HIDDEN), sequence_length=STEPS, synthetic_steps=CLI_T,
                      synthetic_grid=GRID, input_size=PADDED, compute_dtype="bfloat16",
                      snapshot_dir=run_dir, **fields)
    cfg.dump()
    bundle = build_model(cfg.model, in_channels=cfg.in_channels,
                         hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                         compute_dtype="bfloat16")
    params, _ = bundle.init(torch.Generator().manual_seed(SEED), torch.device("cuda", 0))
    save_checkpoint(os.path.join(run_dir, "epoch-001"), params, epoch=1)
    return run_dir


def _nc(path) -> np.ndarray:
    with open_nc(path) as f:
        return np.asarray(f["bcb_conc"])


def _serve_round_trip(run_dir, tag) -> np.ndarray:
    """The serving CLI over the test stream in chunks of CLI_CHUNK, then the
    same stream split in two invocations through --state-out / --skip
    --state-in: equal bits."""
    out = lambda name: os.path.join(run_dir, name)  # noqa: E731
    chunk = ["--chunk", str(CLI_CHUNK)]
    full = serve_cli.main(["--run-dir", run_dir, *chunk, "--out", out("full.nc")])
    serve_cli.main(["--run-dir", run_dir, *chunk, "--steps", str(CLI_CHUNK),
                    "--state-out", out("carry.npz"), "--out", out("p1.nc")])
    serve_cli.main(["--run-dir", run_dir, *chunk, "--skip", str(CLI_CHUNK),
                    "--state-in", out("carry.npz"), "--out", out("p2.nc")])
    whole = _nc(out("full.nc"))
    split = np.concatenate([_nc(out("p1.nc")), _nc(out("p2.nc"))])
    check(whole.shape == (full["steps"], *GRID) and full["steps"] > CLI_CHUNK
          and np.isfinite(whole).all(), f"{tag} served predictions {whole.shape}")
    check(np.array_equal(whole, split), f"{tag} --state-out/--state-in split != one run")
    print(f"{tag} serving CLI, {full['route']}: {full['steps']} steps in chunks of "
          f"{CLI_CHUNK}, {full['model_days_per_min']} model-days/min; steps "
          f"0-{CLI_CHUNK - 1} with --state-out then --skip {CLI_CHUNK} --state-in "
          f"equal one run bit for bit")
    return whole


def _refused_upload(run_dir, device) -> None:
    """(p) C1 under a real refusal: the serving CLI over the training split
    of ``run_dir`` with the allocator capped so that what the process holds
    plus what streaming needs fits, but the forcing slab does not.  The CLI
    tries the resident upload, the allocator raises torch.OutOfMemoryError,
    the CLI says so and streams: predictions bit-equal to --resident-gb 0,
    B1 launched as often.  Run in a process of its own
    (``_refused_upload_fresh``)."""
    t0 = time.perf_counter()
    torch.zeros(1, device=device)  # a new process: start the allocator before its stats
    out = lambda name: os.path.join(run_dir, name)  # noqa: E731
    argv = ["--run-dir", run_dir, "--period", "train", "--chunk", str(CLI_CHUNK)]

    def reserved() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device)

    base = reserved()
    torch.cuda.reset_peak_memory_stats(device)
    _set_counts(0)
    streamed = serve_cli.main([*argv, "--resident-gb", "0", "--out", out("streamed.nc")])
    counts = _counts()
    need = torch.cuda.max_memory_reserved(device) - base
    slab = streamed["steps"] * C * GRID[0] * GRID[1] * 4  # the f32 forcing stream
    check(counts["convlstm_cell"] > 0, f"[p] C1: the streamed run launched no B1: {counts}")
    check(need < slab, f"[p] C1: streaming takes {need} bytes, no less than the "
          f"{slab}-byte slab: no cap refuses one and admits the other")
    base = reserved()
    cap = base + need + (slab - need) // 2
    total = torch.cuda.get_device_properties(device).total_memory
    err = io.StringIO()
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, device)
        _set_counts(0)
        with contextlib.redirect_stderr(err):
            refused = serve_cli.main([*argv, "--resident-gb", "4", "--out", out("refused.nc")])
        _expect_counts("[p] C1 refused upload", **{k: n for k, n in counts.items() if n})
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, device)
    said = err.getvalue()
    sys.stderr.write(said)
    want = (f"serve: device-resident upload of {slab / 1e9:.2f} GB failed "
            "(OutOfMemoryError); streaming chunks from host instead "
            "(--resident-gb 0 silences this)")
    check(want in said, f"[p] C1: no refusal message on stderr: {said!r}")
    check(refused["steps"] == streamed["steps"]
          and np.array_equal(_nc(out("refused.nc")), _nc(out("streamed.nc"))),
          "[p] C1: the refused upload's predictions != --resident-gb 0")
    print(f"[p] C1: allocator capped at {cap / 2**30:.3f} GiB ({base / 2**30:.3f} held "
          f"+ {need / 2**30:.3f} streaming takes + half the gap to the slab) refused "
          f"the {slab / 1e9:.2f} GB upload with torch.OutOfMemoryError; the CLI said so "
          f"and streamed {refused['steps']} steps from the host, bit-equal to "
          f"--resident-gb 0, in {time.perf_counter() - t0:.1f} s")


def _refused_upload_fresh(run_dir) -> None:
    """``_refused_upload`` in a Python process of its own: the cap bounds
    only what the allocator asks of the card, and in this process, after
    the phases before (p), the allocator served the slab from a free block
    of a segment it already held, so nothing was refused.  A new process
    holds no such block.  Its launches stay out of LAUNCHED."""
    sys.stdout.flush()
    code = ("import torch, chip_smoke as cs; "
            f"cs._refused_upload({run_dir!r}, torch.device('cuda', 0))")
    proc = subprocess.run([sys.executable, "-c", code], timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"[p] C1's process exited {proc.returncode}")


def phase_clis(device) -> None:
    """(p) the evaluation and serving CLIs on full-width snapshots: config
    #2 (20-level fusion, C = 62) and config #3 (seq2seq, closed loop); C1,
    the resident upload refused by the allocator, on config #2."""
    root = tempfile.mkdtemp(prefix="niswan_clis_")
    try:
        c2 = _snapshot(root, "c2", levels=20)
        report = eval_cli.main(["--run-dir", c2])
        check(np.isfinite(report["global_r2"]) and np.isfinite(report["pearson_r"]),
              f"[p] evaluation report {report['global_r2']}")
        print(f"[p] evaluation CLI, config #2 snapshot (C={C}): global R2 "
              f"{report['global_r2']:.4f}, {len(report['temporal_r2'])} windows")
        whole = _serve_round_trip(c2, "[p] config #2")
        snap = load_snapshot(c2, device=device)
        art = os.path.join(c2, "rollout.pt2")
        size = export_rollout(snap.bundle.config, snap.dataset.normalizer, snap.params,
                              batch=1, chunk_steps=CLI_CHUNK, n_channels=C,
                              grid_shape=GRID, padded_shape=PADDED, path=art)
        served = serve_cli.main(["--run-dir", c2, "--artifact", art,
                                 "--out", os.path.join(c2, "art.nc")])
        check(np.array_equal(_nc(os.path.join(c2, "art.nc")), whole),
              "[p] --artifact != the live route")
        print(f"[p] --artifact ({size} bytes, chunk {CLI_CHUNK}, exported on the card): "
              f"{served['steps']} steps equal the live route bit for bit")
        _refused_upload_fresh(c2)
        s2s = _snapshot(root, "s2s", mode="seq2seq")
        _serve_round_trip(s2s, "[p] config #3 (closed loop)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# (x) docs/REALDATA.md's canonical training command as written there, but for
# --data-path (the synthetic fixture instead, at X_SYNTHETIC_STEPS),
# --snapshot-dir (a temporary directory), --num-epochs 1 and
# --checkpoint-every 1 (so that epoch-001 is written)
X_SYNTHETIC_STEPS = 240
REALDATA_ARGV = [
    "--model", "LSTM-5C", "--species", "bcb", "--num-epochs", "1", "--batch-size", "8",
    "--sequence-length", "48", "--learning-rate", "1e-3", "--input-size", "100", "154",
    "--in-channels", "5", "--checkpoint-every", "1",
    "--synthetic-steps", str(X_SYNTHETIC_STEPS),
    "--compute-dtype", "bfloat16", "--cell-impl", "auto",
]


def phase_train_cli(device) -> None:
    """(x) the JAX package's documented training command line through the
    port's parse_args and train main, at full width on the card (B1, B2 and
    B3 on the remat route), against the same command without --cell-impl:
    the same launches, logger.npy and the epoch-001 parameters bit-equal."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="niswan_x_")
    try:
        runs = []
        for name, argv in (("with", REALDATA_ARGV),
                           ("without", REALDATA_ARGV[:-2])):  # less --cell-impl auto
            cfg = parse_args([*argv, "--snapshot-dir", os.path.join(root, name)])
            cfg.dump()
            _set_counts(0)
            out = train_cli.main(cfg)
            if not runs:
                counts = _counts()
                check(all(counts[k] > 0 for k in ("convlstm_cell", "cell_bwd", "conv_same")),
                      f"[x] a kernel of the training path ran no time: {counts}")
                for k, n in counts.items():
                    LAUNCHED[k] += n
                print(f"[x] {' '.join(argv)}: launches {counts}")
            else:
                _expect_counts("[x] without --cell-impl", **{k: n for k, n in counts.items() if n})
            with open(os.path.join(cfg.snapshot_dir, "logger.npy"), "rb") as f:
                logs = f.read()
            loaded, opt_state, meta = load_checkpoint(
                os.path.join(cfg.snapshot_dir, "epoch-001"), out["params"])
            check(meta["epoch"] == 1 and all(torch.equal(a, b) for a, b in zip(
                param_leaves(loaded), param_leaves(out["params"]))),
                f"[x] {name} --cell-impl: epoch-001 != the trained parameters")
            runs.append((cfg, logs, loaded, opt_state))
        (cfg_a, logs_a, p_a, o_a), (cfg_b, logs_b, p_b, o_b) = runs
        check(cfg_a.cell_impl == cfg_b.cell_impl == "auto"
              and dataclasses.replace(cfg_a, snapshot_dir=cfg_b.snapshot_dir) == cfg_b,
              f"[x] the configurations differ: {cfg_a} / {cfg_b}")
        check(cfg_a.hidden_channels == HIDDEN and cfg_a.kernel_size == KERNELS
              and cfg_a.input_size == PADDED, f"[x] not the full width: {cfg_a}")
        check(logs_a == logs_b, "[x] logger.npy differs with and without --cell-impl")
        check(all(torch.equal(a, b) for a, b in zip(param_leaves(p_a), param_leaves(p_b)))
              and o_a["step"] == o_b["step"] > 0,
              "[x] epoch-001 differs with and without --cell-impl")
        with open(os.path.join(cfg_a.snapshot_dir, "logger.npy"), "rb") as f:
            loss = [float(np.load(f)[0]) for _ in range(3)]
        print(f"[x] docs/REALDATA.md's command line (--cell-impl auto) on the card: 1 "
              f"epoch, {o_a['step']} steps (bs 8, T 48, C 5, hidden {HIDDEN}, bf16), "
              f"logger.npy {loss}; without --cell-impl: logger.npy and epoch-001 "
              f"bit-equal; {time.perf_counter() - t0:.1f} s for both runs")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_multitracer(device, serve, smi) -> None:
    """(q) S = 3 species at C = 62 as one graph, against three single
    rollouts; batched OAT against serial."""
    cfg, norm = serve["cfg"], serve["norm"]
    kw = dict(padded_shape=PADDED, grid_shape=GRID)
    params = [convlstm_init(torch.Generator().manual_seed(SEED + s), cfg, device=device)
              for s in range(N_SPECIES)]
    rng = np.random.default_rng(SEED + 1)
    forcings = torch.as_tensor(
        rng.standard_normal((N_SPECIES, 1, STEPS, C, *GRID)).astype(np.float32),
        device=device)
    multi = make_multitracer_rollout(cfg, [norm] * N_SPECIES, **kw)
    stacked = stack_params(params)
    multi(stacked, forcings)  # warm-up and capture
    torch.cuda.synchronize()
    _set_counts(0)
    got, _ = multi(stacked, forcings)
    _expect_counts("[q] multi-tracer", convlstm_cell=N_SPECIES * len(HIDDEN) * STEPS)
    runs = []  # replays on the host clock, best of 3
    for _ in range(3):
        t0 = time.perf_counter()
        multi(stacked, forcings)
        torch.cuda.synchronize()
        runs.append(1000 * (time.perf_counter() - t0) / STEPS)
    single = make_rollout_fn(cfg, norm, device=device, **kw)
    for s in range(N_SPECIES):
        want, _ = single(params[s], forcings[s])
        check(torch.equal(got[s], want), f"[q] species {s} != its single rollout")
    print(f"[q] multi-tracer, {N_SPECIES} species at C={C} in one graph "
          f"(captures {multi.runner.captures}): bit-equal to {N_SPECIES} single rollouts; "
          f"{min(runs):.4f} ms/step for all species (replays {runs}, host clock) on {smi}")

    rollout = serve["rollout"]
    f0 = serve["forcings"][0]
    serial = oat_sensitivity(rollout, serve["params"], f0)
    batched = oat_sensitivity(rollout, serve["params"], f0, batched=True)
    scale = serve["preds"][0].std().item()
    worst = max(float(np.sqrt(np.mean((batched[k] - d) ** 2))) / scale
                for k, d in serial.items())
    print(f"[q] OAT over {len(serial)} channels, batched (B={len(serial) + 1}) vs serial: "
          f"rms |d| / std(pred) {worst:.3e} (tol {TOL_PLAIN_REL:g})")
    check(worst <= TOL_PLAIN_REL, f"[q] batched OAT vs serial {worst:.3e}")


# (r) the single-step families at full width: the UNet (features
# 64/128/256/512, bottleneck 1024), the pix2pix generator (features 64) and
# PatchGAN (64/128/256/512), on the 90 x 144 fixture padded to 256 x 256
R_FEATS = (64, 128, 256, 512)
R_PIX_FEATS = 64
R_PADDED = (256, 256)
R_BS = 8
R_T = 90 * 48  # the 90-day fixture: a test split of 864 steps
R_FIT_T = 72  # the fit fixture: 49 training samples, 6 steps of bs 8
R_TIMED_EPOCHS = 3
R_CHUNK = 480  # predict_test_feedback's chunk
R_CPU_STEPS = 8
R_GAN_STEPS = 3
# card (cuDNN, TF32 off) vs CPU, f32: |d| / max |CPU| of one forward (23
# conv layers, sums in other orders), and of the closed loop's first steps,
# each prediction fed back as the next step's input
TOL_R_FWD, TOL_R_LOOP = 1e-4, 1e-3
# the serving CLI against the evaluation CLI on one snapshot, |d| / max:
# the same calls, but pix2pix's transposed convs were measured not to
# repeat bit for bit across runs on the card
TOL_R_CLI = 1e-5
# cuDNN's convolution kernels, FFT-based ones included
_CONV_KERNEL = re.compile(
    r"conv|gemm|xmma|cudnn|dgrad|wgrad|fprop|winograd|fft|complex", re.I)


def unet_flops(cfg, H: int, W: int) -> float:
    """FLOPs of one UNet forward per sample at H x W: 2 x MACs of every conv
    and transposed conv (the norms, pools and activations are not counted)."""
    f = cfg.features
    flops, cin = 0.0, cfg.in_channels
    blocks = []  # (pixels, cin, cout) of each conv_block
    for i, co in enumerate(f):
        blocks.append((H * W >> (2 * i), cin, co))
        cin = co
    blocks.append((H * W >> 8, f[3], 2 * f[3]))  # bottleneck at H/16
    ups = []
    cin = 2 * f[3]
    for i, co in zip(range(3, -1, -1), reversed(f)):
        ups.append((H * W >> (2 * (i + 1)), cin, co))  # k2 s2: 4 taps per input pixel
        blocks.append((H * W >> (2 * i), cin, co))
        cin = co
    for px, ci, co in blocks:
        flops += 2 * px * 9 * (ci * co + co * co)
    for px, ci, co in ups:
        flops += 2 * px * 4 * ci * co
    return flops + 2 * H * W * f[0] * cfg.out_channels


def _rel(got, want) -> float:
    return float((got.detach().float().cpu() - want.detach().float().cpu()).abs().max()
                 / want.detach().float().abs().max())


def _batch_statistics(bundle, params, state, x):
    """``state`` with its running statistics set to the batch statistics of
    ``x`` (one training-mode forward: new = 0.9 old + 0.1 batch).  Fresh
    (0, 1) statistics leave only the head's bias in an eval-mode output of
    the N(0, 0.02) weights; matched ones normalize as training does."""
    with torch.no_grad():
        _, new = bundle.apply(params, state, x, training=True)
    return tree_unflatten(state, [(n - 0.9 * o) / 0.1
                                  for n, o in zip(tree_leaves(new), tree_leaves(state))])


def _timed_epochs(step, params, state, dataset, device, epochs, rng=None):
    """bench.py main_train's loop over ``epochs`` epochs of ``dataset``: the
    wait on ``async_batches``' queue, then the step; synchronised at the
    end.  Returns (ms/step, host_input_wait_frac, steps, state)."""
    torch.cuda.synchronize()
    tic, wait, n = time.perf_counter(), 0.0, 0
    for epoch in range(epochs):
        it = async_batches(dataset, R_BS, shuffle=True, seed=SEED, epoch=epoch, device=device)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            state, _ = step(params, state, *batch, rng=rng)
            n += 1
    torch.cuda.synchronize()
    total = time.perf_counter() - tic
    return 1000 * total / n, wait / total, n, state


def _conv_share(names) -> tuple:
    """(conv kernels' device ms, all kernels' device ms, the five longest
    kernels) of a profile's kernels by name."""
    total = sum(ms for _, ms in names.values())
    conv = sum(ms for k, (_, ms) in names.items() if _CONV_KERNEL.search(k))
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:5]
    return conv, total, [(k[:60], n, round(ms, 3)) for k, (n, ms) in top]


def _single_step_snapshot(root, name, model, device, **fields) -> str:
    """A full-width single-step snapshot of seeded weights (and, for the
    UNet, random BatchNorm statistics) over the synthetic stream."""
    run_dir = os.path.join(root, name)
    cfg = TrainConfig(model=model, synthetic_steps=CLI_T, synthetic_grid=GRID,
                      input_size=R_PADDED, unet_features=R_FEATS,
                      pix2pix_features=R_PIX_FEATS, snapshot_dir=run_dir, **fields)
    cfg.dump()
    bundle = build_model(model, in_channels=cfg.in_channels, unet_features=R_FEATS,
                         pix2pix_features=R_PIX_FEATS)
    params, state = bundle.init(torch.Generator().manual_seed(SEED), device)
    if state is not None:
        x = torch.randn((2, *R_PADDED, cfg.in_channels), device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED))
        state = _batch_statistics(bundle, params, state, x)
    save_checkpoint(os.path.join(run_dir, "epoch-001"), params, epoch=1, model_state=state)
    return run_dir


def phase_single_step(device, smi) -> None:
    """(r) the single-step families at full width (f32, TF32 off): the
    UNet-5ch forward on the card against the CPU, UNet training through
    ``fit`` (its checkpoint's BatchNorm state read back), the UNet-6ch
    closed loop over the 90-day fixture's test split as graph replays
    against the eager body and the CPU, pix2pix generator training, one
    GAN step, and both CLIs on full-width single-step snapshots.  None of
    it runs a kernel of the port: its convolutions, norms and pools are
    PyTorch's (cuDNN), as the JAX package's are XLA's."""
    cpu = torch.device("cpu")
    root = tempfile.mkdtemp(prefix="niswan_single_")
    _set_counts(0)
    try:
        # --- UNet-5ch forward, card vs CPU, B = 8 -----------------------
        fit_data = synthetic_e33oma_90d(T=R_FIT_T, H=GRID[0], W=GRID[1], seed=SEED)
        train5, val5 = (SingleStepDataset(fit_data, period=p) for p in ("train", "val"))
        unet = build_model("UNet-r", in_channels=5, unet_features=R_FEATS)
        p_cpu, s_cpu = unet.init(torch.Generator().manual_seed(SEED), cpu)
        n_params = sum(t.numel() for t in tree_leaves(p_cpu))
        prep = make_preprocess_fn(train5.normalizer, R_PADDED)
        xs, ys = zip(*(train5[i] for i in range(R_BS)))
        x_cpu, y_cpu = prep(np.stack(xs), np.stack(ys))
        x_dev = x_cpu.to(device)
        p_dev = _tree_to(p_cpu, device)
        s_dev = _batch_statistics(unet, p_dev, _tree_to(s_cpu, device), x_dev)
        s_cpu = _tree_to(s_dev, cpu)
        for training in (False, True):
            with torch.no_grad():
                want, want_s = unet.apply(p_cpu, s_cpu, x_cpu, training=training)
                got, got_s = unet.apply(p_dev, s_dev, x_cpu.to(device), training=training)
            err = max(_rel(g, w) for g, w in zip(tree_leaves((got, got_s)),
                                                  tree_leaves((want, want_s))))
            check(torch.isfinite(got).all() and err <= TOL_R_FWD,
                  f"[r] UNet forward training={training}: card vs CPU {err:.3e}")
            print(f"[r] UNet-5ch forward (features {R_FEATS}, {n_params} parameters, "
                  f"B={R_BS}, {R_PADDED[0]}x{R_PADDED[1]}, f32) training={training}: "
                  f"card vs CPU max |d| / max |CPU| {err:.3e} over the output and the "
                  f"new running statistics (tol {TOL_R_FWD:g})")
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: unet.apply(p_dev, s_dev, x_dev)[0], n=5)
        gflop = unet_flops(unet.config, *R_PADDED) / 1e9
        bound = least_time(R_BS * gflop * 1e9, 0, torch.float32)[0]
        print(f"[r] UNet forward: {gflop:.2f} GFLOP per sample; B={R_BS} eval forward "
              f"{fwd_ms:.2f} ms (CUDA events), FP32 bound {bound:.2f} ms on {smi}")
        del p_dev, s_dev, x_dev, got, got_s, want, want_s

        # --- UNet training through fit ------------------------------------
        cfg = TrainConfig(model="UNet-r", in_channels=5, unet_features=R_FEATS,
                          input_size=R_PADDED, batch_size=R_BS, num_epochs=1,
                          learning_rate=1e-3, betas=(0.5, 0.999), checkpoint_every=1,
                          snapshot_dir=os.path.join(root, "unet"), device=str(device))
        p0, s0 = unet.init(torch.Generator().manual_seed(SEED), device)
        out = fit(unet, train5, val5, cfg, device=device, init_params=p0, init_state=s0,
                  verbose=False)
        check(np.isfinite(out["logger"]["MSELoss"]).all(), f"[r] fit {out['logger']}")
        tmpl, tmpl_state = unet.init(torch.Generator().manual_seed(SEED + 2), device)
        lp, lo, ls, meta = load_checkpoint(os.path.join(cfg.snapshot_dir, "epoch-001"), tmpl,
                                           state_template=tmpl_state)
        check(meta["n_state"] == 36 and lo["step"] == len(train5) // R_BS and all(
            torch.equal(a, b) for a, b in zip(tree_leaves((lp, ls)),
                                              tree_leaves((out["params"], out["state"])))),
            "[r] the UNet checkpoint does not load back equal")
        print(f"[r] UNet fit: 1 epoch of {lo['step']} steps (bs {R_BS}), logger "
              f"{out['logger']}; epoch-001 (s<i> BatchNorm state, n_state "
              f"{meta['n_state']}) loads back equal")
        opt = make_optimizer(out["params"], 1e-3, (0.5, 0.999))
        step = make_train_step(unet, train5.normalizer, opt, padded_shape=R_PADDED,
                               grid_shape=GRID)
        # the peak covers the first epoch's capture (the graph's private pool)
        torch.cuda.reset_peak_memory_stats(device)
        state = _timed_epochs(step, out["params"], out["state"], train5, device, 1)[3]
        ms, frac, n, state = _timed_epochs(step, out["params"], state, train5, device,
                                           R_TIMED_EPOCHS)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        it = async_batches(train5, R_BS, shuffle=False, device=device)
        batch = next(it)
        it.close()
        # the eager body under the profiler (the same kernels as a replay; a
        # profiler late in a long process can miss a replay's kernels, (v))
        dev_ms, names = _profile(lambda: [step.eager(out["params"], state, *batch)
                                          for _ in range(2)])
        eager = _host_ms(lambda: step.eager(out["params"], state, *batch))
        conv, total, top = _conv_share(names)
        bound = least_time(3 * R_BS * gflop * 1e9, 0, torch.float32)[0]
        print(f"[r] UNet training (fit's step, Adam lr 1e-3 betas (0.5, 0.999), MSE + L1 "
              f"on the cropped map): {ms:.1f} ms/step over {n} steps (graph replays; the "
              f"eager body {eager:.1f}), "
              f"host_input_wait_frac {frac:.4f}, peak memory {peak:.2f} GiB; device "
              f"{dev_ms / 2:.1f} ms/step (profiler kernel sum), conv kernels "
              f"{conv / 2:.1f} ms/step ({100 * conv / total:.1f}%); FP32 bound of "
              f"3 x the forward's FLOPs {bound:.1f} ms; top kernels {top} on {smi}")
        del out, opt, step, state, batch, lp, ls, tmpl, tmpl_state, p0, s0
        torch.cuda.empty_cache()

        # --- UNet-6ch closed loop: graph vs eager vs CPU -------------------
        test6 = SingleStepDataset(synthetic_e33oma_90d(T=R_T, H=GRID[0], W=GRID[1],
                                                       seed=SEED),
                                  period="test", in_channels=6)
        unet6 = build_model("UNet-r6", in_channels=6, unet_features=R_FEATS)
        p6_cpu, s6_cpu = unet6.init(torch.Generator().manual_seed(SEED + 3), cpu)
        frames, targets = test6.feedback_stream()
        x6, _ = make_preprocess_fn(test6.normalizer, R_PADDED)(frames[:R_BS], targets[:R_BS])
        p6 = _tree_to(p6_cpu, device)
        s6 = _batch_statistics(unet6, p6, _tree_to(s6_cpu, device), x6.to(device))
        s6_cpu = _tree_to(s6, cpu)
        frames_dev = torch.as_tensor(frames, device=device)
        prev0 = frames_dev[0, 5]
        steps = frames.shape[0]
        run = make_feedback_chunk(unet6, test6.normalizer, padded_shape=R_PADDED,
                                  grid_shape=GRID)

        def episode(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = _run_chunked_episode(lambda st, prev, x: fn(p6, st, prev, x),
                                         [s6, prev0], frames_dev, R_CHUNK)
            return preds, 1000 * (time.perf_counter() - t0)

        first = {}
        for name in ("eager", "first_graph_call", "replay"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn = run.eager if name == "eager" else run
            fn(p6, s6, prev0, frames_dev[:R_CHUNK])
            torch.cuda.synchronize()
            first[name] = 1000 * (time.perf_counter() - t0)
        graph_p, graph_ms = episode(run)
        eager_p, eager_ms = episode(run.eager)
        entry = predict_test_feedback(unet6, p6, s6, test6, padded_shape=R_PADDED)
        check(np.array_equal(graph_p, eager_p) and np.array_equal(entry["PDs"], graph_p)
              and np.isfinite(graph_p).all() and graph_p.shape == targets.shape,
              "[r] UNet-6ch closed loop: graph replays != eager body")
        check(run.runner.captures == int(device.type == "cuda"),
              f"[r] closed loop captured {run.runner.captures}x")
        cpu_run = make_feedback_chunk(unet6, test6.normalizer, padded_shape=R_PADDED,
                                      grid_shape=GRID)
        _, _, cpu_p = cpu_run.eager(p6_cpu, s6_cpu, torch.from_numpy(frames[0, 5]),
                                    frames[:R_CPU_STEPS])
        err = _rel(torch.from_numpy(graph_p[:R_CPU_STEPS]), cpu_p)
        check(err <= TOL_R_LOOP, f"[r] closed loop vs CPU {err:.3e}")
        dev_ms, _ = _profile(lambda: run(p6, s6, prev0, frames_dev[:R_CHUNK]))
        print(f"[r] UNet-6ch closed loop over the test split ({steps} steps, B=1, chunks of "
              f"{R_CHUNK}, each one graph replay): graph == eager bit for bit, "
              f"predict_test_feedback == both, first {R_CPU_STEPS} steps vs the CPU loop "
              f"{err:.3e} (tol {TOL_R_LOOP:g}); host clock {graph_ms / steps:.3f} ms/step "
              f"graph, {eager_ms / steps:.3f} ms/step eager; device "
              f"{dev_ms / R_CHUNK:.3f} ms/step (profiler kernel sum); a {R_CHUNK}-step "
              f"chunk served once: eager {first['eager']:.0f} ms, graph first call "
              f"(one-step warm-up + capture + replay) {first['first_graph_call']:.0f} ms, "
              f"replay {first['replay']:.0f} ms; FP32 bound "
              f"{least_time(unet_flops(unet6.config, *R_PADDED), 0, torch.float32)[0]:.3f}"
              " ms/step "
              f"on {smi}")
        del run, frames_dev, p6, s6, entry
        torch.cuda.empty_cache()

        # --- pix2pix generator training --------------------------------------
        pix = build_model("PIX2PIX-r", in_channels=5, pix2pix_features=R_PIX_FEATS)
        g0, _ = pix.init(torch.Generator().manual_seed(SEED), device)
        pcfg = dataclasses.replace(cfg, model="PIX2PIX-r", snapshot_dir=os.path.join(root, "pix"),
                                   checkpoint_every=0)
        pout = fit(pix, train5, val5, pcfg, device=device, init_params=g0, verbose=False)
        check(np.isfinite(pout["logger"]["MSELoss"]).all(), f"[r] pix2pix fit {pout['logger']}")
        gen = torch.Generator(device=device).manual_seed(SEED)
        g_leaves = [t.detach().clone() for t in tree_leaves(pout["params"])]
        popt = make_optimizer(pout["params"], 1e-3, (0.5, 0.999))
        pstep = make_train_step(pix, train5.normalizer, popt, padded_shape=R_PADDED,
                                grid_shape=GRID)
        torch.cuda.reset_peak_memory_stats(device)
        _timed_epochs(pstep, pout["params"], None, train5, device, 1, rng=gen)
        ms, frac, n, _ = _timed_epochs(pstep, pout["params"], None, train5, device,
                                       R_TIMED_EPOCHS, rng=gen)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        check(all(torch.isfinite(t).all() for t in tree_leaves(pout["params"])) and not all(
            torch.equal(a, b) for a, b in zip(g_leaves, tree_leaves(pout["params"]))),
            "[r] pix2pix training did not move the generator")
        pb = tuple(torch.as_tensor(np.stack(a), device=device) for a in (xs, ys))
        eager = _host_ms(lambda: pstep.eager(pout["params"], None, *pb, rng=gen))
        print(f"[r] pix2pix generator training (features {R_PIX_FEATS}, bs {R_BS}, dropout "
              f"on): fit "
              f"logger {pout['logger']}; {ms:.1f} ms/step over {n} steps (graph replays; "
              f"the eager body {eager:.1f}), "
              f"host_input_wait_frac {frac:.4f}, peak memory {peak:.2f} GiB on {smi}")
        del popt, pstep

        # --- one full-width GAN step -----------------------------------------
        dcfg = DiscriminatorConfig(in_channels=1, features=R_FEATS)
        d_params = discriminator_init(torch.Generator().manual_seed(SEED), dcfg, device=device)
        for t in tree_leaves(d_params):
            t.requires_grad_(True)
        g_params = pout["params"]
        before = [t.detach().clone() for t in tree_leaves((g_params, d_params))]
        gan = make_gan_train_step(pix.config, dcfg,
                                  make_optimizer(g_params, 2e-4, (0.5, 0.999)),
                                  make_optimizer(d_params, 2e-4, (0.5, 0.999)))
        x, y = prep(np.stack(xs), np.stack(ys))
        x = x.to(device)
        y = torch.movedim(pad_geo(y[:, None], R_PADDED), 1, -1).to(device)
        torch.cuda.reset_peak_memory_stats(device)
        gan(g_params, d_params, x, y, gen)  # warm-up: an eager step, then the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(R_GAN_STEPS):
            metrics = gan(g_params, d_params, x, y, gen)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0) / R_GAN_STEPS
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        eager = _host_ms(lambda: gan.eager(g_params, d_params, x, y, gen))
        vals = {k: v.item() for k, v in metrics.items()}
        after = tree_leaves((g_params, d_params))
        n_g = len(tree_leaves(g_params))
        check(all(np.isfinite(v) for v in vals.values())
              and not all(torch.equal(a, b) for a, b in zip(before[:n_g], after[:n_g]))
              and not all(torch.equal(a, b) for a, b in zip(before[n_g:], after[n_g:])),
              f"[r] GAN step {vals}: a network did not move")
        print(f"[r] GAN step (generator features {R_PIX_FEATS}, PatchGAN {R_FEATS}, bs {R_BS}, "
              f"{R_PADDED[0]}x{R_PADDED[1]}): losses {vals}, both networks moved; "
              f"{ms:.1f} ms/step over {R_GAN_STEPS} steps (graph replays; the eager body "
              f"{eager:.1f}), peak memory {peak:.2f} GiB on {smi}")
        del gan, g_params, d_params, pout, x, y
        torch.cuda.empty_cache()

        # --- both CLIs on full-width single-step snapshots ------------------
        for name, model, fields in (("u6", "UNet-smoke", dict(in_channels=6)),
                                    ("p2", "PIX2PIX-smoke", {})):
            run_dir = _single_step_snapshot(root, name, model, device, **fields)
            on = ["--run-dir", run_dir, "--device", str(device)]
            report = eval_cli.main(on)
            served = serve_cli.main([*on, "--chunk", str(R_CHUNK),
                                     "--out", os.path.join(run_dir, "p.nc")])
            with open(os.path.join(run_dir, "test-results.npy"), "rb") as f:
                np.load(f)
                pds = np.load(f)
            err = _rel(torch.from_numpy(_nc(os.path.join(run_dir, "p.nc"))),
                       torch.from_numpy(pds))
            check(served["route"] == "single_step" and np.isfinite(report["global_r2"])
                  and served["steps"] == len(pds) and err <= TOL_R_CLI,
                  f"[r] {model} CLIs: route {served['route']}, serve vs evaluate {err:.3e}")
            print(f"[r] {model} snapshot (full width, {CLI_T}-step synthetic stream): "
                  f"evaluation CLI global R2 {report['global_r2']:.4f}, pearson r "
                  f"{report['pearson_r']:.4f}; serving CLI route {served['route']}, "
                  f"{served['steps']} steps, max |d| / max against the evaluation's "
                  f"predictions {err:.3e} (tol {TOL_R_CLI:g})")
        _expect_counts("[r] single-step families (no kernel of the port on this path)")
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


# (s) B1 on (lat, lon) tiles of the 100 x 154 frame at the serving layers;
# (1, 1) is the zero-extended whole frame the one-rank sharded path runs
TILE_MESHES = ((1, 1), (2, 2), (2, 7))
SHARD_CHUNKS = 2  # chained 48-step chunks of the sharded rollout
DP_STEPS = 3


def graph_ms(fn, n: int = 48, reps: int = 5) -> float:
    """Device time of one ``fn()`` launched ``n`` times back to back in a
    CUDA graph, replayed ``reps`` times (CUDA events): a launch's time
    without the host's dispatch, as it runs in a serving graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def _tiled_b1(device, gen, shape, tiles) -> dict:
    """B1 on every halo-extended tile of a (lat, lon) cut of one frame (the
    halos sliced from the zero-padded frame): each tile against the plain
    cell on the same inputs (TOL_CELL), and the stitched tiles against B1 on
    the whole frame; returns the max |d| of both, bit-equality and the
    times."""
    B, H, W, cin, hid, k = shape
    lat, lon = tiles
    p, th, tw = k // 2, H // lat, W // lon
    ext = (B, th + 2 * p, tw + 2 * p, cin, hid, k)
    plan = check_wgmma(ext, "[s]")
    xh = torch.randn((B, H, W, cin), generator=gen, device=device).to(torch.bfloat16)
    c = torch.randn((B, H, W, hid), generator=gen, device=device)
    w = (torch.randn((k, k, cin, 4 * hid), generator=gen, device=device)
         / (k * k * cin) ** 0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn((4 * hid,), generator=gen, device=device)
    h_full, c_full = fused_cell_forward(xh, c, w, b)
    xp, cp = (torch.nn.functional.pad(t, (0, 0, p, p, p, p)) for t in (xh, c))
    cut = [(i, j, xp[:, i * th:i * th + th + 2 * p, j * tw:j * tw + tw + 2 * p].contiguous(),
            cp[:, i * th:i * th + th + 2 * p, j * tw:j * tw + tw + 2 * p].contiguous())
           for i in range(lat) for j in range(lon)]
    h_st, c_st = torch.empty_like(h_full), torch.empty_like(c_full)
    d_plain = 0.0
    for i, j, xt, ct in cut:
        ht, ct2 = fused_cell_forward(xt, ct, w, b)
        hp, cp2 = fused_cell_forward_plain(xt, ct, w, b)
        d_plain = max(d_plain, (ht - hp).abs().max().item(), (ct2 - cp2).abs().max().item())
        h_st[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = ht[:, p:p + th, p:p + tw]
        c_st[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = ct2[:, p:p + th, p:p + tw]
    torch.cuda.synchronize()
    d = max((h_st - h_full).abs().max().item(), (c_st - c_full).abs().max().item())
    bit = torch.equal(h_st, h_full) and torch.equal(c_st, c_full)
    check(d_plain <= TOL_CELL, f"[s] B1 vs plain on {tiles} tiles of {ext[1]} x {ext[2]} "
          f"{d_plain:.3e}")
    check(d <= TOL_CELL, f"[s] B1 on {tiles} tiles vs the whole frame {d:.3e}")
    _, _, xt, ct = cut[0]  # every tile has the one extended shape
    n = lat * lon
    tile_ms = cuda_ms(lambda: fused_cell_forward(xt, ct, w, b))
    plain_ms = cuda_ms(lambda: fused_cell_forward_plain(xt, ct, w, b))
    full_ms = cuda_ms(lambda: fused_cell_forward(xh, c, w, b))
    tile_rep = graph_ms(lambda: fused_cell_forward(xt, ct, w, b))
    full_rep = graph_ms(lambda: fused_cell_forward(xh, c, w, b))
    row = _row(ext, tile_ms, plain_ms, cell_work(*ext), plan=plan, replay_ms=tile_rep,
               max_abs_err=d_plain,
               launches_per_step=f"{n} per serving step on {lat} x {lon} tiles")
    print(f"[s] B1 {shape} on {lat} x {lon} tiles of {ext[1]} x {ext[2]}: every tile vs "
          f"the plain cell max |d| {d_plain:.3e} (tol {TOL_CELL:g}); stitched vs "
          f"whole frame max |d| {d:.3e} ({'bit-equal' if bit else 'not bit-equal'}); "
          f"{n} tiles {n * tile_rep:.4f} ms vs whole frame {full_rep:.4f} ms of device time "
          f"in a graph (x{n * tile_rep / full_rep:.3f}; pixels x"
          f"{n * ext[1] * ext[2] / (H * W):.3f}), eager {n * tile_ms:.4f} vs {full_ms:.4f} "
          f"ms, one tile {tile_rep:.4f} ms against its bound {row['bound_ms']:.4f}, "
          f"{plan} mainloop")
    return {"d": d, "d_plain": d_plain, "bit": bit, "row": row}


def _timed_steps(step, params, batches):
    """The metrics of one step per batch, and the mean host-clock ms of the
    steps after the first."""
    metrics, times = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(params, None, idx)[1])
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    return metrics, float(np.mean(times[1:]))


def _rel_std(got, want):
    """(max |d|, rms |d|) over the std of ``want``, and bit-equality."""
    d = (got - want).float()
    scale = want.float().std().item()
    return (d.abs().max().item() / scale, d.pow(2).mean().sqrt().item() / scale,
            torch.equal(got, want))


def _flat(tree) -> list:
    """The tensors of nested tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _flat(x)]


def _chained(step, fn, carry):
    """SHARD_CHUNKS chunks through ``step(fn, carry, k) -> (preds, carry)``,
    synchronised; (the predictions, the last carry, host-clock seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = []
    for k in range(SHARD_CHUNKS):
        p, carry = step(fn, carry, k)
        preds.append(p)
    torch.cuda.synchronize()
    return preds, carry, time.perf_counter() - t0


def _sharded_entries(device, serve, mesh, smi) -> None:
    """(s) each sharded serving entry point on the one-rank mesh at full
    width, SHARD_CHUNKS chained 48-step chunks: replayed (one CUDA graph a
    chunk) with exact B1 counts, bit-equal to ``.eager`` (the oracle), and
    within TOL_CHUNK of the unsharded graph (predictions over the std,
    carries absolute); replay, eager and unsharded-graph ms/step on the
    host clock beside the replay's device time."""
    from nasa_niswan_tpu_torch.parallel import spatial

    cfg, params, norm, forcings = (serve[k] for k in ("cfg", "params", "norm", "forcings"))
    geo = dict(padded_shape=PADDED, grid_shape=GRID)
    S, L = N_SPECIES, len(HIDDEN)
    rng = np.random.default_rng(SEED + 2)

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)

    stacked = stack_params([convlstm_init(torch.Generator().manual_seed(SEED + s), cfg,
                                          device=device) for s in range(S)])
    mt_f = [draw(S, 1, STEPS, C, *GRID) for _ in range(SHARD_CHUNKS)]
    # config #5's own width (4 meteorology channels and one emission)
    cfg5 = dataclasses.replace(cfg, in_channels=5)
    stacked5 = stack_params([convlstm_init(torch.Generator().manual_seed(SEED + 10 + s),
                                           cfg5, device=device) for s in range(S)])
    norms5 = [Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.1 * s, 1.0 + s)
              for s in range(S)]
    met = [draw(1, STEPS, 4, *GRID) for _ in range(SHARD_CHUNKS)]
    emis = [draw(S, 1, STEPS, *GRID) for _ in range(SHARD_CHUNKS)]
    fb_norm = Normalizer(norm.x_mean[:-1], norm.x_std[:-1], norm.y_mean, norm.y_std)
    prev0 = draw(1, *GRID)

    def fb_step(fn, carry, k):
        st, prev, p = fn(params, *carry, forcings[k][0, :, : C - 1])
        return p, (st, prev)

    entries = (
        ("rollout", spatial.make_sharded_rollout_fn(cfg, norm, mesh, **geo),
         serve["rollout"], lambda fn, st, k: fn(params, forcings[k], st), None, None, L,
         lambda st: spatial.gather_state(st, mesh)),
        ("multi-tracer", spatial.make_sharded_multitracer_rollout(cfg, [norm] * S, mesh,
                                                                  **geo),
         make_multitracer_rollout(cfg, [norm] * S, **geo),
         lambda fn, st, k: fn(stacked, mt_f[k], st), None, None, S * L,
         lambda st: spatial.gather_state(st, mesh, batch_axis=1)),
        ("shared multi-tracer (C=5)",
         spatial.make_sharded_multitracer_rollout_shared(cfg5, norms5, mesh, **geo),
         make_multitracer_rollout_shared(cfg5, norms5, **geo),
         lambda fn, st, k: fn(stacked5, met[k], emis[k], st), None, None, S * L,
         lambda st: spatial.gather_state(st, mesh, batch_axis=1)),
        ("closed loop", spatial.make_sharded_feedback_rollout(cfg, fb_norm, mesh, **geo),
         make_closed_loop_chunk(cfg, fb_norm, **geo), fb_step,
         (spatial.zero_tile_state(cfg, 1, PADDED, mesh), prev0),
         (zero_closed_loop_state(cfg, PADDED, device), prev0), L,
         lambda c: (spatial.gather_state(c[0], mesh), c[1])),
    )
    n_steps = SHARD_CHUNKS * STEPS
    for name, sh, ref, step, init_sh, init_ref, cells, gather in entries:
        step(sh, init_sh, 0)  # warm-up on one step, capture, replay
        step(ref, init_ref, 0)
        _set_counts(0)
        got, carry, t_rep = _chained(step, sh, init_sh)
        _expect_counts(f"[s] sharded {name}, replayed", convlstm_cell=cells * n_steps)
        eager, carry_e, t_eager = _chained(step, sh.eager, init_sh)
        want, carry_r, t_ref = _chained(step, ref, init_ref)
        bit = all(torch.equal(a, b) for a, b in zip(_flat([got, carry]),
                                                    _flat([eager, carry_e])))
        check(all(bool(torch.isfinite(p).all()) and p.shape == q.shape
                  for p, q in zip(got, want)), f"[s] sharded {name}: shapes, finite")
        d_pred = max(_rel_std(p, q)[0] for p, q in zip(got, want))
        d_carry = max((a - b).abs().max().item()
                      for a, b in zip(_flat(gather(carry)), _flat(carry_r)))
        dev_ms, _ = _profile(lambda: step(sh, init_sh, 0))
        dev_ref, _ = _profile(lambda: step(ref, init_ref, 0))
        print(f"[s] sharded {name} (1, 1, 1), {SHARD_CHUNKS} chained {STEPS}-step chunks "
              f"(captures {sh.runner.captures}): replay vs .eager "
              f"{'bit-equal' if bit else 'NOT bit-equal'}; vs the unsharded graph "
              f"max|d|/std {d_pred:.3e}, carry max|d| {d_carry:.3e} (tol {TOL_CHUNK:g}); "
              f"host clock: replay {1000 * t_rep / n_steps:.4f}, eager "
              f"{1000 * t_eager / n_steps:.4f}, unsharded graph "
              f"{1000 * t_ref / n_steps:.4f} ms/step; device time (profiler kernel sum, "
              f"one chunk) replay {dev_ms / STEPS:.4f}, unsharded graph "
              f"{dev_ref / STEPS:.4f} ms/step (B=1, bf16) on {smi}")
        check(bit, f"[s] sharded {name}: replay != eager")
        check(max(d_pred, d_carry) <= TOL_CHUNK,
              f"[s] sharded {name}: vs unsharded {d_pred:.3e}, carry {d_carry:.3e}")


def phase_sharded(device, serve, train, stats, smi) -> None:
    """(s) the sharded serving and data-parallel paths on a one-rank NCCL
    group, B1 on halo-extended tiles, the sharded serving CLI and the
    config #5 scripts."""
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh

    store = tempfile.mkdtemp(prefix="smoke-nccl-")
    init_distributed("file://" + os.path.join(store, "store"), 1, 0, device_type="cuda")
    try:
        mesh = make_mesh()
        _sharded_entries(device, serve, mesh, smi)

        bundle = build_model("LSTM-smoke", **train["kw"])
        pa, pb = _copy_params(train["init"]), _copy_params(train["init"])
        step_a = train["make_step"](bundle, pa)
        step_b = make_device_train_step(bundle, train["ds"].normalizer,
                                        make_optimizer(pb, 1e-3, (0.5, 0.999)), train["src"],
                                        mesh=mesh, **train["geo"])
        order = train["order"]
        batches = [order[s * TRAIN_BS:(s + 1) * TRAIN_BS] for s in range(DP_STEPS)]
        torch.cuda.synchronize()
        _set_counts(0)
        mb, t_dp = _timed_steps(step_b, pb, batches)
        want = len(HIDDEN) * TRAIN_T * DP_STEPS
        _expect_counts("[s] data-parallel step (1 rank)", convlstm_cell=want, cell_bwd=want,
                       conv_same=want)
        ma, t_one = _timed_steps(step_a, pa, batches)
        same = all(torch.equal(a, b) for a, b in zip(param_leaves(pa), param_leaves(pb)))
        loss_eq = all(torch.equal(a["loss"], b["loss"]) for a, b in zip(ma, mb))
        dr2 = max(abs(a["r2"].item() - b["r2"].item()) for a, b in zip(ma, mb))
        print(f"[s] data-parallel step, 1 rank, remat route (bs {TRAIN_BS}, T {TRAIN_T}), "
              f"{DP_STEPS} steps vs make_device_train_step: parameters "
              f"{'bit-equal' if same else 'differ'}, losses "
              f"{'bit-equal' if loss_eq else 'differ'}, |d R2| {dr2:.3e} (R2 from summed "
              f"statistics); steps after the first {t_dp:.1f} vs {t_one:.1f} ms/step "
              f"(host clock; the first builds the optimizer state and, for the DP "
              f"step, NCCL's communicator) on {smi}")
        check(same and loss_eq and dr2 <= 1e-5, "[s] one-rank DP step != the device step")
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    _sharded_clis()
    _campaign_scripts(smi)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for tiles in TILE_MESHES:
        for shape in CELL_SHAPES[:3]:
            res = _tiled_b1(device, gen, shape, tiles)
            stats["convlstm_cell"]["by_shape"].append(res["row"])
            stats["convlstm_cell"]["max_abs_err"] = max(stats["convlstm_cell"]["max_abs_err"],
                                                        res["d_plain"])

    if torch.cuda.device_count() < 2:
        print("[s] the cross-card phase needs >= 2 cards; "
              f"{torch.cuda.device_count()} visible: not run")
        return
    from nasa_niswan_tpu_torch.parallel import launch

    out = launch.spawn(two_rank_phase, 2, "cuda", "cuda", dict(
        C=C, hidden=HIDDEN, kernels=KERNELS, grid=GRID, padded=PADDED, steps=STEPS,
        bs=TRAIN_BS, T=TRAIN_T), timeout=600)
    print(f"[s] two ranks on two cards: {out[0]}")
    check(out[0]["rollout_max"] <= TOL_CHUNK and out[0]["dp_loss_rel"] <= 1e-5
          and out[0]["replay_is_eager"], f"[s] two-rank phase {out[0]}")


def _sharded_clis() -> None:
    """(s) the serving CLI with ``--sharded 1 1`` (one rank spawned on the
    card by launch.spawn, NCCL) against the unsharded CLI, on full-width
    config #2 and config #3 (closed loop) snapshots."""
    root = tempfile.mkdtemp(prefix="niswan_sharded_")
    try:
        for name, fields in (("c2", dict(levels=20)), ("s2s", dict(mode="seq2seq"))):
            run_dir = _snapshot(root, name, **fields)
            out = lambda n, d=run_dir: os.path.join(d, n)  # noqa: E731
            argv = ["--run-dir", run_dir, "--chunk", str(CLI_CHUNK)]
            one = serve_cli.main([*argv, "--out", out("one.nc")])
            t0 = time.perf_counter()
            sh = serve_cli.main([*argv, "--out", out("sharded.nc"), "--sharded", "1", "1"])
            t_sh = time.perf_counter() - t0
            a, b = _nc(out("one.nc")), _nc(out("sharded.nc"))
            check(sh["sharded"] == [1, 1] and sh["route"] == one["route"]
                  and a.shape == b.shape and np.isfinite(b).all(),
                  f"[s] --sharded 1 1 {name}: {sh}, shape {b.shape}")
            mx = float(np.abs(a - b).max() / a.std())
            print(f"[s] serving CLI --sharded 1 1 ({name}, {sh['route']}, one rank spawned "
                  f"on the card, NCCL): {sh['steps']} steps vs the unsharded CLI max|d|/std "
                  f"{mx:.3e} (tol {TOL_CHUNK:g}; "
                  f"{'bit-equal' if np.array_equal(a, b) else 'not bit-equal'}); "
                  f"{t_sh:.1f} s with the rank's start-up")
            check(mx <= TOL_CHUNK, f"[s] --sharded 1 1 {name} max|d|/std {mx:.3e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# (s) config #5's scripts, at a size their outputs name
SCRIPT_DEMO = ["--steps", "480", "--epochs", "1", "--chunk", "96"]
SCRIPT_DECADAL = ["--train-steps", "480", "--epochs", "1", "--year-steps", "960",
                  "--years", "2", "--chunk", "240"]


def _script(name: str):
    """scripts/<name>.py imported as the module ``name`` (a rank it spawns
    imports it by that name)."""
    import importlib.util

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(name, os.path.join(scripts, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _finite(obj) -> bool:
    """Every number in a JSON-like object is finite."""
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or bool(np.isfinite(obj))


def _campaign_scripts(smi) -> None:
    """(s) scripts/torch_bench_sharded_rollout.py (the plain cell and B1
    inside the one-rank sharded rollout, eager and replayed),
    torch_run_multitracer_demo.py (SCRIPT_DEMO: three emulators trained,
    served as one graph) and torch_run_decadal_rollout.py (SCRIPT_DECADAL,
    from the demo's checkpoints) on one device and with ``--sharded 1 1``
    (one rank spawned, NCCL): every number they write finite, the sharded
    decade's step count and per-year R^2 equal to the unsharded one's
    (the same launches on the same data)."""
    root = tempfile.mkdtemp(prefix="niswan_config5_")
    try:
        bench = _script("torch_bench_sharded_rollout")
        for rec in bench.main(["--steps", "96", "--reps", "2"]):
            check(_finite(rec), f"[s] bench_sharded_rollout {rec}")
            print(f"[s] torch_bench_sharded_rollout (96 steps, C={C}): {rec} on {smi}")
        demo = os.path.join(root, "demo")
        res = _script("torch_run_multitracer_demo").main([*SCRIPT_DEMO, "--out", demo])
        check(_finite(res), f"[s] multitracer demo {res}")
        print(f"[s] torch_run_multitracer_demo {' '.join(SCRIPT_DEMO)}: {json.dumps(res)}")
        dec = {}
        decadal = _script("torch_run_decadal_rollout")
        for name, extra in (("one device", []), ("--sharded 1 1", ["--sharded", "1", "1"])):
            dec[name] = decadal.main([*SCRIPT_DECADAL, "--ckpt-root", demo, "--out",
                                      os.path.join(root, name.replace(" ", "_")), *extra])
            check(_finite(dec[name]), f"[s] decadal {name} {dec[name]}")
            print(f"[s] torch_run_decadal_rollout {' '.join(SCRIPT_DECADAL + extra)}: "
                  f"{json.dumps(dec[name])}")
        one, sh = dec["one device"], dec["--sharded 1 1"]
        d_r2 = max(abs(a[k] - b[k]) for a, b in zip(one["per_year_r2"], sh["per_year_r2"])
                   for k in a)
        print(f"[s] decadal rollout --sharded 1 1 vs one device: {sh['total_steps']} vs "
              f"{one['total_steps']} steps, per-year R2 max|d| {d_r2:.3e} (tol "
              f"{TOL_CHUNK:g}), layer-1 h rms {sh['layer1_h_rms_by_year']} vs "
              f"{one['layer1_h_rms_by_year']}")
        check(sh["total_steps"] == one["total_steps"] and d_r2 <= TOL_CHUNK
              and sh["layer1_h_rms_by_year"] == one["layer1_h_rms_by_year"],
              "[s] sharded decadal rollout != one device")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def two_rank_phase(rank: int, device_type: str, size: dict) -> dict:
    """The two-rank checks of (s), one rank per device: the (1, 1, 2)
    sharded rollout (a graph replay on the cards, its halo messages and
    gathers captured) equal to its eager body and against the
    single-device rollout (eager) on rank 0's device, and the dp = 2 remat
    step against the one-rank step on the same
    global batch.  ``size`` gives the widths (the card's full width; small
    on the CPU)."""
    from nasa_niswan_tpu_torch.parallel import spatial
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh

    C_, grid, padded, T = size["C"], tuple(size["grid"]), tuple(size["padded"]), size["T"]
    mesh = make_mesh(1, 1, 2)
    dev = mesh.device
    cfg = ConvLSTMConfig(in_channels=C_, hidden_channels=tuple(size["hidden"]),
                         kernel_sizes=tuple(size["kernels"]), compute_dtype="bfloat16")
    params = convlstm_init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    rng = np.random.default_rng(SEED)
    f = torch.as_tensor(rng.standard_normal((1, size["steps"], C_, *grid), dtype=np.float32),
                        device=dev)
    norm = Normalizer(np.zeros(C_, np.float32), np.ones(C_, np.float32), 0.0, 1.0)
    geo = dict(padded_shape=padded, grid_shape=grid)
    roll = spatial.make_sharded_rollout_fn(cfg, norm, mesh, **geo)
    t0 = time.perf_counter()
    p, _ = roll(params, f)  # on the cards: warm-up, capture (NCCL inside), replay
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_sh = time.perf_counter() - t0
    same = bool(torch.equal(p, roll.eager(params, f)[0]))  # every rank sends its halos
    out = {}
    if rank == 0:
        out["replay_is_eager"] = same
        q, _ = make_rollout_fn(cfg, norm, device=dev, **geo).eager(params, f)
        out["rollout_rms"] = ((p - q).pow(2).mean().sqrt() / q.std()).item()
        out["rollout_max"] = ((p - q).abs().max() / q.std()).item()
        out["sharded_ms_per_step"] = 1000 * t_sh / size["steps"]

    dmesh = make_mesh(2, 1, 1)
    data = synthetic_e33oma_90d(T=2 * T + 8, H=grid[0], W=grid[1], seed=SEED)
    ds = SequenceDataset(data, period="train", sequence_length=T, in_channels=5)
    bundle = build_model("LSTM-dp2", in_channels=5, hidden_channels=tuple(size["hidden"]),
                         kernel_sizes=tuple(size["kernels"]), compute_dtype="bfloat16")
    idx = np.arange(size["bs"]) % len(ds)
    x, y = (np.stack(a) for a in zip(*(ds[int(i)] for i in idx)))
    bl = size["bs"] // 2
    init, _ = bundle.init(torch.Generator().manual_seed(SEED), dev)
    pd = _copy_params(init)
    step = make_train_step(bundle, ds.normalizer, make_optimizer(pd, 1e-3, (0.5, 0.999)),
                           mesh=dmesh, **geo)
    _, m = step(pd, None, x[rank * bl:(rank + 1) * bl], y[rank * bl:(rank + 1) * bl])
    if rank == 0:
        p1 = _copy_params(init)
        one = make_train_step(bundle, ds.normalizer, make_optimizer(p1, 1e-3, (0.5, 0.999)),
                              **geo)
        _, m1 = one(p1, None, x, y)
        out["dp_loss_rel"] = abs(m["loss"].item() - m1["loss"].item()) / m1["loss"].item()
    return out


# (t) training at scale: the canonical step with the grid sharded, on a
# one-rank NCCL mesh (the tile is the zero-extended frame); B2, its dW
# kernels and B3 on the halo-extended tiles of TILE_MESHES; the one-rank
# UNet DP step (global BatchNorm through NCCL); an async checkpoint while
# steps run
T_STEPS = 3
# the canonical step's routes through make_spatial_train_step
T_ROUTES = (("remat", dict(remat=True)), ("per-cell", dict(remat=False)),
            ("hoist", dict(precompute_input_conv=True)))
TOL_T_UNET = 1e-5
UNET_NOISE = ("conv1/b", "conv2/b")  # conv biases ahead of BatchNorm: zero gradient
UNET_SHOWN = "dec4/block/conv1/w"  # the leaf farthest from its f64 value in earlier runs


def _leaf_rel(got, want):
    """Per leaf ``_rel_max``."""
    return [_rel_max(g, w) for g, w in zip(got, want)]


def _one_step_grads(step_of, bundle, init, x_raw, y_raw):
    """The gradients one step leaves in ``.grad`` (after its all-reduce)
    from a copy of ``init``, and the step's loss."""
    p = _copy_params(init)
    _, m = step_of(bundle, p)(p, None, x_raw, y_raw)
    return [t.grad.detach().clone() for t in param_leaves(p)], m["loss"].item()


def _timed_host(step, params, batches):
    """Host-clock ms/step over ``batches`` (synchronised), and the last
    metrics."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x_raw, y_raw in batches:
        _, m = step(params, None, x_raw, y_raw)
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / len(batches), m


def _spatial_steps(device, train, mesh, smi) -> None:
    """(t) the canonical step sharded over the one-rank mesh, on the remat,
    per-cell and hoisted routes (T_ROUTES), against the single-device step:
    per-leaf gradients (bf16 at T 48, f32 at T 8) within TOL_GRAD of the
    leaf's largest, exact launch counts over T_STEPS counted steps of each,
    equal between the two, ms/step (host clock and profiler device time)
    and peak memory beside the single-device step's."""
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    src, ds, geo, init, kw = (train[k] for k in ("src", "ds", "geo", "init", "kw"))
    order = train["order"]
    batches = [src.gather(order[s * TRAIN_BS:(s + 1) * TRAIN_BS]) for s in range(T_STEPS + 1)]
    x_raw, y_raw = batches[0]

    def sharded(bundle, p):
        return make_spatial_train_step(bundle, ds.normalizer,
                                       make_optimizer(p, 1e-3, (0.5, 0.999)), mesh, **geo)

    def one(bundle, p):
        return make_train_step(bundle, ds.normalizer, make_optimizer(p, 1e-3, (0.5, 0.999)),
                               **geo)

    for route, opts in T_ROUTES:
        for dtype, T in (("bfloat16", TRAIN_T), ("float32", GRAD_T)):
            bundle = build_model("LSTM-smoke", **opts, **dict(kw, compute_dtype=dtype))
            g_sh, l_sh = _one_step_grads(sharded, bundle, init, x_raw[:, :T], y_raw)
            g_one, l_one = _one_step_grads(one, bundle, init, x_raw[:, :T], y_raw)
            rel = _leaf_rel(g_sh, g_one)
            print(f"[t] sharded step (1, 1, 1), {route} route, {dtype}, T={T}: loss "
                  f"{l_sh:.6f} vs single-device {l_one:.6f}; per-leaf max |d g| / max |g| "
                  f"{max(rel):.3e} (tol {TOL_GRAD[dtype]:g}); leaves "
                  f"{[f'{r:.1e}' for r in rel]}")
            check(max(rel) <= TOL_GRAD[dtype] and abs(l_sh - l_one) <= 1e-3 * abs(l_one),
                  f"[t] sharded {route} {dtype} gradients {max(rel):.3e}, loss {l_sh} vs "
                  f"{l_one}")
            del g_sh, g_one
        bundle = build_model("LSTM-smoke", **opts, **kw)
        times, counts = {}, {}
        n = len(HIDDEN) * TRAIN_T * T_STEPS
        # layer 0's first step needs no input gradient; the hoist is one
        # more B3 (its forward) and one more dW per step, and its layer 0
        # launches B1's xg and emit_gates modes at once (counted under
        # emit_gates)
        want = {"remat": dict(convlstm_cell=n, cell_bwd=n, conv_same=n),
                "per-cell": dict(convlstm_cell_gates=n, conv_same=n - T_STEPS, conv_dw=n),
                "hoist": dict(convlstm_cell_gates=n, conv_same=n,
                              conv_dw=n + T_STEPS)}[route]
        for name, make in (("sharded", sharded), ("single-device", one)):
            p = _copy_params(init)
            step = make(bundle, p)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # warm-up: Adam's state, allocator growth, the capture
            step(p, None, *batches[0])
            _set_counts(0)
            ms, m = _timed_host(step, p, batches[1:])
            counts[name] = _expect_counts(f"[t] {name} step, {route} route", **want)
            peak = torch.cuda.max_memory_allocated() / 2**30
            dev_ms = _event_ms(lambda: step(p, None, *batches[1]))
            eager, _ = _timed_host(step.eager, p, batches[1:])
            check(bool(torch.isfinite(m["loss"])), f"[t] {name} {route} loss")
            times[name] = (ms, dev_ms, peak, eager)
            del p, step
            torch.cuda.empty_cache()
        check(counts["sharded"] == counts["single-device"],
              f"[t] {route} launches: sharded {counts['sharded']} vs single-device "
              f"{counts['single-device']}")
        (a, da, pa, ea), (b, db, pb, eb) = times["sharded"], times["single-device"]
        print(f"[t] {route} route (bs {TRAIN_BS}, T {TRAIN_T}, C={TRAIN_C}, bf16), "
              f"{T_STEPS} steps: sharded (1 rank) {a:.1f} ms/step host clock (graph "
              f"replays; eager body {ea:.1f}), {da:.1f} ms device (a replay's CUDA-event "
              f"span), peak {pa:.2f} GiB; single-device {b:.1f} ms/step (eager body "
              f"{eb:.1f}), {db:.1f} ms device, peak {pb:.2f} GiB on {smi}")


def _b2_alone(device, gen, shape, tag0, **extra) -> dict:
    """B2 (``fused_cell_bwd``: gate recompute, elementwise backward, dW) at
    one shape, bf16, on the wgmma plan, against its plain version with
    (f)'s bounds, reruns bit-identical; the shape's row (kernel, plain and
    bound times, the largest |error|)."""
    B, H, W, cin, hid, k = shape
    plan = check_wgmma(shape, f"{tag0} cell_bwd")
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    xh, c, dh, dc = rand(B, H, W, cin).bfloat16(), rand(B, H, W, hid), rand(B, H, W, hid), \
        rand(B, H, W, hid)
    w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
    b = 0.1 * rand(4 * hid)
    args = (xh, c, dh, dc, w, b)
    got, again, want = fused_cell_bwd(*args), fused_cell_bwd(*args), fused_cell_bwd_plain(*args)
    torch.cuda.synchronize()
    tag = f"B={B} H={H} W={W} Cin={cin} hid={hid} k={k} bfloat16"
    check(all(torch.equal(x, y) for x, y in zip(got, again)), f"cell_bwd reruns differ at {tag}")
    d = {"dgates": _max_excess(got[0], want[0], 2.0**-7),
         "dc_prev": (got[1] - want[1]).abs().max().item(),
         "dw": _rel_max(got[2], want[2]), "db": _rel_max(got[3], want[3])}
    check(d["dgates"] <= 1e-5, f"{tag0} dgates {d['dgates']:.3e} at {tag}")
    for name in ("dc_prev", "dw", "db"):
        check(d[name] <= BWD_BOUNDS[name], f"{tag0} {name} {d[name]:.3e} at {tag}")
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
    ms = cuda_ms(lambda: fused_cell_bwd(*args), 5)
    plain_ms = cuda_ms(lambda: fused_cell_bwd_plain(*args), 5)
    row = _row(shape, ms, plain_ms, cell_bwd_work(*shape), plan=plan, library_ms=None,
               max_abs_err=err, **extra)
    print(f"{tag0} cell_bwd {tag}: dgates excess {d['dgates']:.3e}, |d dc_prev| "
          f"{d['dc_prev']:.3e}, rel |d dw| {d['dw']:.3e}, |d db| {d['db']:.3e}; "
          f"bit-identical reruns; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms, {plan} mainloop")
    del args, got, again, want
    return row


def _frame_ms(device, gen, shape) -> tuple:
    """Kernel ms of B2, dW and B3 on the whole frame at a training layer,
    bf16 (CUDA events)."""
    B, H, W, cin, hid, k = shape
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    xh, c = rand(B, H, W, cin).bfloat16(), rand(B, H, W, hid)
    w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
    b, g = 0.1 * rand(4 * hid), rand(B, H, W, 4 * hid).bfloat16()
    w_flip = flip_kernel(w)
    ms = (cuda_ms(lambda: fused_cell_bwd(xh, c, c, c, w, b), 5),
          cuda_ms(lambda: convgrad.conv_dw(xh, g, k), 5),
          cuda_ms(lambda: conv_same(g, w_flip), 5))
    del xh, c, w, b, g, w_flip
    return ms


def _tile_kernels(device, stats, smi) -> None:
    """(t) B1 (plain, the remat route's forward, and emit_gates, the
    per-cell route's), B2, its dW kernels alone and B3 on the halo-extended
    tiles of each (lat, lon) cut of TILE_MESHES at the three training
    layers (B=8), each against its plain version at (c)'s, (i)'s and (f)'s
    bounds, with kernel, plain, bound and cuDNN times; the cut's tiles
    summed beside the whole frame.  The rows join the B1 entries' and the
    cell_bwd, dw and conv_same entries' by_shape."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    entry = stats["cell_bwd"]
    b2_rows = entry.setdefault("by_shape", [])
    for shape in BWD_SHAPES[:3]:
        B, H, W, cin, hid, k = shape
        whole = _frame_ms(device, gen, shape)
        for tiles in TILE_MESHES:
            n, p = tiles[0] * tiles[1], k // 2
            th, tw = H // tiles[0] + 2 * p, W // tiles[1] + 2 * p
            per = f"{n} x {TRAIN_T} per sharded step on {tiles[0]} x {tiles[1]} tiles"
            extra = dict(tiles=list(tiles), launches_per_step=per)
            _cell_alone(device, gen, stats, (B, th, tw, cin, hid, k), "[t]",
                        {"plain": per + " (remat route)", "gates": per + " (per-cell route)"},
                        tiles=list(tiles))
            r2 = _b2_alone(device, gen, (B, th, tw, cin, hid, k), "[t]", **extra)
            rdw = _dw_alone(device, gen, (B, th, tw, cin, 4 * hid, k), "[t]", **extra)
            rows3 = []
            e3 = _b3_alone(device, gen, rows3, shapes=((B, th, tw, 4 * hid, cin, k),),
                           tag0="[t]", **extra)
            entry["max_abs_err"] = max(entry["max_abs_err"], r2["max_abs_err"])
            entry["dw"]["max_abs_err"] = max(entry["dw"]["max_abs_err"],
                                             rdw.pop("max_abs_err"))
            stats["conv_same"]["max_abs_err"] = max(stats["conv_same"]["max_abs_err"], e3)
            del rdw["flops"], rdw["bytes"]
            b2_rows.append(r2)
            entry["dw"]["by_shape"].append(rdw)
            stats["conv_same"]["by_shape"].extend(rows3)
            ms = (r2["ms"], rdw["ms"], rows3[0]["ms"])
            print(f"[t] layer Cin={cin} hid={hid} k={k} on {tiles[0]} x {tiles[1]} tiles of "
                  f"{th} x {tw} (pixels x{n * th * tw / (H * W):.3f} of the frame): {n} "
                  f"tiles of B2 {n * ms[0]:.4f} ms, dW {n * ms[1]:.4f} ms, B3 "
                  f"{n * ms[2]:.4f} ms vs the whole {H} x {W} frame's {whole[0]:.4f}, "
                  f"{whole[1]:.4f}, {whole[2]:.4f} ms (x{n * ms[0] / whole[0]:.3f}, "
                  f"x{n * ms[1] / whole[1]:.3f}, x{n * ms[2] / whole[2]:.3f}) on {smi}")
    _hoist_tile_kernels(device, gen, stats, smi)
    torch.cuda.empty_cache()


def _hoist_tile_kernels(device, gen, stats, smi) -> None:
    """(t) the hoisted route's kernels on the whole frame and on the
    halo-extended tiles of each (lat, lon) cut of TILE_MESHES, bf16: B3 as
    the hoisted input conv over every frame of the step (N = B T = 384,
    Cin 8 -> 4 hid 256, k 5), B2's dW kernel over the same frames, and
    layer 0's B1 xg + emit_gates launch (B 8, h alone: Cin 64), each
    against its plain version as ``_b3_alone``, ``_dw_alone`` and
    ``_cell_alone`` hold them, with kernel, plain, bound and cuDNN times;
    the rows join conv_same's, dw's and convlstm_cell_gates' by_shape."""
    N, k, hid = TRAIN_BS * TRAIN_T, KERNELS[0], HIDDEN[0]
    H, W = PADDED
    entry = stats["cell_bwd"]
    rows3 = []
    err = _b3_alone(device, gen, rows3, shapes=((N, H, W, TRAIN_C, 4 * hid, k),),
                    tag0="[t] hoist", tiles=None, launches_per_step="1 per hoisted step")
    whole = rows3[0]["ms"]
    for tiles in TILE_MESHES:
        n, p = tiles[0] * tiles[1], k // 2
        th, tw = H // tiles[0] + 2 * p, W // tiles[1] + 2 * p
        per = f"{n} per sharded hoisted step on {tiles[0]} x {tiles[1]} tiles"
        extra = dict(tiles=list(tiles), launches_per_step=per)
        err = max(err, _b3_alone(device, gen, rows3, shapes=((N, th, tw, TRAIN_C, 4 * hid, k),),
                                 tag0="[t] hoist", **extra))
        rdw = _dw_alone(device, gen, (N, th, tw, TRAIN_C, 4 * hid, k), "[t] hoist", **extra)
        entry["dw"]["max_abs_err"] = max(entry["dw"]["max_abs_err"], rdw.pop("max_abs_err"))
        del rdw["flops"], rdw["bytes"]
        entry["dw"]["by_shape"].append(rdw)
        _cell_alone(device, gen, stats, (TRAIN_BS, th, tw, hid, hid, k), "[t] hoist",
                    {"xg": f"{n} x {TRAIN_T} per sharded hoisted step on {tiles[0]} x "
                           f"{tiles[1]} tiles"}, modes=("xg",), tiles=list(tiles))
        print(f"[t] hoisted conv on {tiles[0]} x {tiles[1]} tiles of {th} x {tw}: {n} tiles "
              f"of B3 {n * rows3[-1]['ms']:.4f} ms, dW {n * rdw['ms']:.4f} ms vs B3 on the "
              f"whole {H} x {W} frame {whole:.4f} ms on {smi}")
    stats["conv_same"]["max_abs_err"] = max(stats["conv_same"]["max_abs_err"], err)
    stats["conv_same"]["by_shape"].extend(rows3)


def unet_dp_errors(unet, p0, s0, batch, normalizer, padded, grid, mesh) -> dict:
    """The UNet's DP step on ``mesh``, its spatially sharded step on it
    (``make_spatial_train_step``: the tile path, halos, the gather rule,
    BatchNorm over the mesh) and the single-device step from ``p0`` /
    ``s0`` on one raw batch, each in f32 and in f64 (weights, state and
    batch cast), against the gradient of the same loss through
    ``unet.apply`` in f64 (no step, no mesh).  Per leaf with a nonzero
    exact gradient, relative to that leaf's largest |g64| (path -> max
    |g - g64| / max |g64|): ``f64_dp``, ``f64_one``, ``f64_sp``,
    ``f64_d`` (dp against one, both f64), ``f64_sp_d`` (sharded against
    one); ``err_dp``, ``err_one``, ``err_sp`` (the f32 steps).  ``state``,
    ``state_sp`` = the dp and sharded f32 running statistics' largest
    per-leaf |d| / max |one|; ``noise`` = the f32 conv biases ahead of a
    BatchNorm (a zero gradient in exact arithmetic), |g| over the model's
    largest gradient; the f32 losses; the dp step's f32 state."""
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    paths = tree_paths(p0)
    out = {}
    geo = dict(padded_shape=padded, grid_shape=grid)
    steps = {"dp": lambda opt: make_train_step(unet, normalizer, opt, mesh=mesh, **geo),
             "one": lambda opt: make_train_step(unet, normalizer, opt, **geo),
             "sp": lambda opt: make_spatial_train_step(unet, normalizer, opt, mesh, **geo)}
    for dtype in (torch.float32, torch.float64):
        cast = lambda t: t.detach().to(dtype, copy=True)  # noqa: E731  (Adam steps in place)
        for name, make in steps.items():
            p = tree_map(lambda t: cast(t).requires_grad_(True), p0)
            step = make(make_optimizer(p, 1e-3, (0.5, 0.999)))
            state, metrics = step(p, tree_map(cast, s0), *(cast(t) for t in batch))
            out[name, dtype] = ([t.grad.detach().clone() for t in param_leaves(p)],
                                tree_leaves(state), metrics["loss"].item(), state)
            del p, step
    x, y = make_preprocess_fn(normalizer, padded)(*(t.double() for t in batch))
    p64 = tree_map(lambda t: t.detach().double().requires_grad_(True), p0)
    pred, _ = unet.apply(p64, tree_map(lambda t: t.double(), s0), x, training=True)
    d = y - crop_to_grid(pred[..., 0], grid)
    g64 = torch.autograd.grad(torch.mean(d * d) + torch.mean(d.abs()), param_leaves(p64))
    del p64, pred, d
    scale = max(g.abs().max().item() for g in g64)

    def err(got, want=g64):
        return {path: (a.double() - b.double()).abs().max().item() / c.abs().max().item()
                for path, a, b, c in zip(paths, got, want, g64)
                if not path.endswith(UNET_NOISE)}

    g_dp, s_dp, l_dp, state_dp = out["dp", torch.float32]
    g_one, s_one, l_one, _ = out["one", torch.float32]
    g_sp, s_sp, l_sp, _ = out["sp", torch.float32]
    g_dp64, g_one64, g_sp64 = (out[k, torch.float64][0] for k in ("dp", "one", "sp"))
    return dict(
        f64_dp=err(g_dp64), f64_one=err(g_one64), f64_d=err(g_dp64, g_one64),
        f64_sp=err(g_sp64), f64_sp_d=err(g_sp64, g_one64),
        err_dp=err(g_dp), err_one=err(g_one), err_sp=err(g_sp),
        state=max(_leaf_rel(s_dp, s_one)), state_sp=max(_leaf_rel(s_sp, s_one)),
        noise=max(max(a.abs().max().item(), b.abs().max().item(), c.abs().max().item()) / scale
                  for path, a, b, c in zip(paths, g_dp, g_one, g_sp)
                  if path.endswith(UNET_NOISE)),
        loss_dp=l_dp, loss_one=l_one, loss_sp=l_sp, state_dp=state_dp)


def _unet_dp_step(device, mesh, smi) -> None:
    """(t) the UNet's DP step on the one-rank mesh (its BatchNorms' sums
    all-reduced through NCCL) against the single-device step at (r)'s
    width (``unet_dp_errors``).  On one rank the all-reduce is the
    identity: the global statistics across ranks are held by the CPU
    two-rank tests; here the DP code path (BatchNorm from all-reduced sums,
    the gradient all-reduce) is held against the single-device one.  In
    f32 a leaf whose gradient is a small difference of large terms is up to
    7e-2 of its own largest from its f64 value in either path (printed, not
    held), so the gradients are held in f64, per leaf within TOL_T_UNET of
    the leaf's largest: dp against one device and both against the f64
    gradient of the loss.  In f32: the new running statistics within
    TOL_T_UNET of each leaf's largest, the conv biases ahead of a BatchNorm
    below 1e-6 of the largest gradient in both, the losses rel 1e-5.
    The spatially sharded step (``make_spatial_train_step``: the tile
    path with zero halos, BatchNorm over the mesh) is held the same way.
    ms/step of the three, f32."""
    data = synthetic_e33oma_90d(T=R_FIT_T, H=GRID[0], W=GRID[1], seed=SEED)
    ds = SingleStepDataset(data, period="train")
    unet = build_model("UNet-t", in_channels=5, unet_features=R_FEATS)
    p0, s0 = unet.init(torch.Generator().manual_seed(SEED), device)
    batches = [tuple(torch.as_tensor(np.stack(a), device=device) for a in zip(
        *(ds[i] for i in range(s * R_BS, (s + 1) * R_BS)))) for s in range(T_STEPS + 1)]
    e = unet_dp_errors(unet, p0, s0, batches[0], ds.normalizer, R_PADDED, GRID, mesh)
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    ms, geo = {}, dict(padded_shape=R_PADDED, grid_shape=GRID)
    for name in ("dp", "one", "sp"):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
        opt = make_optimizer(p, 1e-3, (0.5, 0.999))
        step = (make_spatial_train_step(unet, ds.normalizer, opt, mesh, **geo) if name == "sp"
                else make_train_step(unet, ds.normalizer, opt, mesh=mesh if name == "dp"
                                     else None, **geo))
        step(p, s0, *batches[0])  # warm-up
        ms[name], _ = _timed_host(lambda q, _s, x, y: step(q, s0, x, y), p, batches[1:])
        ms[name, "eager"], _ = _timed_host(lambda q, _s, x, y: step.eager(q, s0, x, y), p,
                                           batches[1:])
        del p, step
    f64 = {k: max(e[k].values()) for k in ("f64_dp", "f64_one", "f64_d", "f64_sp", "f64_sp_d")}
    dp, one = e["err_dp"], e["err_one"]
    shown = dict.fromkeys(k for k in (UNET_SHOWN, max(dp, key=dp.get), max(one, key=one.get))
                          if k in dp)
    print(f"[t] UNet DP step (1 rank, BatchNorm sums all-reduced over NCCL; features "
          f"{R_FEATS}, bs {R_BS}, {R_PADDED[0]}x{R_PADDED[1]}) vs the single-device step: "
          f"f32 loss {e['loss_dp']:.6f} vs {e['loss_one']:.6f}; f64 gradients, largest "
          f"per-leaf max |d g| / max |g| of the leaf over {len(dp)} leaves: dp vs one "
          f"{f64['f64_d']:.3e}, dp vs the f64 loss gradient {f64['f64_dp']:.3e}, one vs it "
          f"{f64['f64_one']:.3e}, the spatially sharded step (make_spatial_train_step on "
          f"the one-rank mesh) vs one {f64['f64_sp_d']:.3e}, vs the f64 loss gradient "
          f"{f64['f64_sp']:.3e}, f32 loss {e['loss_sp']:.6f}, running statistics per leaf "
          f"{e['state_sp']:.3e} (tol {TOL_T_UNET:g}); f32 gradients against the f64 loss "
          f"gradient, per leaf (dp, one device): "
          + "; ".join(f"{k} {dp[k]:.3e}, {one[k]:.3e}" for k in shown)
          + f"; running statistics per leaf {e['state']:.3e} (tol {TOL_T_UNET:g}); conv "
          f"biases ahead of BatchNorm |g| / max |g| {e['noise']:.3e} (<= 1e-6); "
          f"dp {ms['dp']:.1f}, sharded {ms['sp']:.1f} vs single-device {ms['one']:.1f} "
          f"ms/step (host clock, f32, graph replays; eager bodies {ms['dp', 'eager']:.1f}, "
          f"{ms['sp', 'eager']:.1f}, {ms['one', 'eager']:.1f}) on {smi}")
    check(max(f64.values()) <= TOL_T_UNET and max(e["state"], e["state_sp"]) <= TOL_T_UNET
          and e["noise"] <= 1e-6
          and max(abs(e["loss_dp"] - e["loss_one"]), abs(e["loss_sp"] - e["loss_one"]))
          <= 1e-5 * e["loss_one"],
          f"[t] UNet DP and sharded steps: "
          f"{dict((k, v) for k, v in e.items() if k != 'state_dp')}")
    torch.cuda.empty_cache()


def _pix2pix_spatial_step(device, mesh, smi) -> None:
    """(t) the pix2pix generator's spatially sharded step on the one-rank
    mesh (the tile path: reflect and zero halos, InstanceNorm sums over the
    plane, the gather rule, dropout drawn from one generator) against the
    single-device step at (r)'s width (features 64, bs 8, 256 x 256), from
    the same weights, batch and dropout seed.  In f32 the generator's
    gradients at its initial weights amplify rounding through its
    InstanceNorms over 2 x 2 maps, so the gradients are held in f64, per
    leaf within TOL_T_UNET of the leaf's largest; the f32 losses rel 1e-5;
    ms/step of both, f32."""
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    data = synthetic_e33oma_90d(T=R_FIT_T, H=GRID[0], W=GRID[1], seed=SEED)
    ds = SingleStepDataset(data, period="train")
    gen = build_model("PIX2PIX-t", in_channels=5, pix2pix_features=R_PIX_FEATS)
    p0, _ = gen.init(torch.Generator().manual_seed(SEED), device)
    batches = [tuple(torch.as_tensor(np.stack(a), device=device) for a in zip(
        *(ds[i] for i in range(s * R_BS, (s + 1) * R_BS)))) for s in range(T_STEPS + 1)]
    geo = dict(padded_shape=R_PADDED, grid_shape=GRID)
    makes = {"sp": lambda opt: make_spatial_train_step(gen, ds.normalizer, opt, mesh, **geo),
             "one": lambda opt: make_train_step(gen, ds.normalizer, opt, **geo)}
    out = {}
    for dtype in (torch.float32, torch.float64):
        for name, make in makes.items():
            p = tree_map(lambda t: t.detach().to(dtype, copy=True).requires_grad_(True), p0)
            step = make(make_optimizer(p, 1e-3, (0.5, 0.999)))
            rng = torch.Generator(device=device).manual_seed(SEED)
            _, m = step(p, None, *(t.to(dtype) for t in batches[0]), rng)
            out[name, dtype] = ([t.grad.detach().clone() for t in param_leaves(p)],
                                m["loss"].item())
            del p, step
    rel = _leaf_rel(out["sp", torch.float64][0], out["one", torch.float64][0])
    rel32 = _leaf_rel(out["sp", torch.float32][0], out["one", torch.float32][0])
    l_sp, l_one = out["sp", torch.float32][1], out["one", torch.float32][1]
    ms = {}
    for name, make in makes.items():
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
        step = make(make_optimizer(p, 1e-3, (0.5, 0.999)))
        rng = torch.Generator(device=device).manual_seed(SEED)
        step(p, None, *batches[0], rng)  # warm-up
        ms[name], m = _timed_host(lambda q, _s, x, y: step(q, None, x, y, rng), p, batches[1:])
        ms[name, "eager"], _ = _timed_host(lambda q, _s, x, y: step.eager(q, None, x, y, rng),
                                           p, batches[1:])
        check(bool(torch.isfinite(m["loss"])), f"[t] pix2pix {name} loss")
        del p, step
    print(f"[t] pix2pix generator, spatially sharded step (1 rank; features {R_PIX_FEATS}, "
          f"bs {R_BS}, {R_PADDED[0]}x{R_PADDED[1]}, dropout from one seed) vs the "
          f"single-device step: f64 gradients per leaf max |d g| / max |g| {max(rel):.3e} "
          f"(tol {TOL_T_UNET:g}); f32 {max(rel32):.3e} (printed); f32 loss {l_sp:.6f} vs "
          f"{l_one:.6f}; sharded {ms['sp']:.1f} vs single-device {ms['one']:.1f} ms/step "
          f"(host clock, f32, graph replays; eager bodies {ms['sp', 'eager']:.1f}, "
          f"{ms['one', 'eager']:.1f}) on {smi}")
    check(max(rel) <= TOL_T_UNET and abs(l_sp - l_one) <= 1e-5 * abs(l_one),
          f"[t] pix2pix sharded step: gradients {max(rel):.3e}, loss {l_sp} vs {l_one}")
    torch.cuda.empty_cache()


ASYNC_REPS = 5


def _async_save(device, train, smi) -> None:
    """(t) an async checkpoint of the canonical model while steps run: the
    restored parameters and Adam moments bit-equal to those at the first
    save.  What a save costs the step loop, ASYNC_REPS times in turn (the
    medians printed): T_STEPS steps alone; ``save()`` and the same number
    of steps after it; a synchronous ``save_checkpoint`` of the same state
    (what the npz backend does at an epoch's end) and the steps after it;
    the cost is the time over the steps alone."""
    from nasa_niswan_tpu_torch.train.checkpoint_async import AsyncCheckpointer

    bundle = build_model("LSTM-smoke", **train["kw"])
    params = _copy_params(train["init"])
    opt = make_optimizer(params, 1e-3, (0.5, 0.999))
    step = make_device_train_step(bundle, train["ds"].normalizer, opt, train["src"],
                                  **train["geo"])
    order = train["order"]
    _train_run(step, params, 1, order)  # warm-up: Adam's state

    def steps():
        return _train_run(step, params, T_STEPS, order[TRAIN_BS:])[0]

    def timed(save):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save()
        t_call = time.perf_counter() - t0
        return t_call, t_call + steps()

    root = tempfile.mkdtemp(prefix="niswan_ckpt_")
    try:
        ck = AsyncCheckpointer(os.path.join(root, "orbax"))
        rows = []
        for rep in range(ASYNC_REPS):
            plain = steps()
            if rep == 0:
                at_save = [t.detach().clone() for t in param_leaves(params)]
                moments = [opt.state[t]["exp_avg"].clone() for t in param_leaves(params)]
            call, with_async = timed(lambda: ck.save(rep + 1, params, opt, learning_rate=1e-3))
            if rep == 0:  # the first save against the values it was given
                ck.wait()
                restored, opt_state, meta = ck.restore_latest(_copy_params(train["init"]))
                same = all(torch.equal(a, b) for a, b in zip(param_leaves(restored), at_save))
                same_m = all(np.array_equal(a, b.cpu().numpy())
                             for a, b in zip(opt_state["exp_avg"], moments))
                moved = not all(torch.equal(a, b)
                                for a, b in zip(param_leaves(params), at_save))
            ck.wait()
            sync, with_sync = timed(lambda: save_checkpoint(
                os.path.join(root, "npz"), params, opt, learning_rate=1e-3, epoch=rep + 1))
            rows.append([1000 * v for v in (plain, call, with_async - plain, sync,
                                            with_sync - plain)])
        committed = ck.committed()
        ck.close()
        plain, call, cost_async, sync, cost_sync = np.median(np.array(rows), axis=0)
        print(f"[t] async checkpoint of the canonical model ({committed}): the first save's "
              f"restored parameters {'bit-equal' if same else 'differ'} and Adam moments "
              f"{'bit-equal' if same_m else 'differ'} to those at the save; the steps after "
              f"it moved the live ones: {moved}; medians of {ASYNC_REPS} (host clock): "
              f"{T_STEPS} steps {plain / T_STEPS:.1f} ms/step alone; save() returned in "
              f"{call:.2f} ms, its cost to the loop (the save and the {T_STEPS} steps after "
              f"it, over the steps alone) {cost_async:.2f} ms; synchronous save_checkpoint "
              f"{sync:.2f} ms, its cost {cost_sync:.2f} ms; per rep (steps, save(), async "
              f"cost, sync save, sync cost) {[[round(v, 2) for v in r] for r in rows]} "
              f"on {smi}")
        check(same and same_m and moved and meta["epoch"] == 1, "[t] async checkpoint")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train_at_scale(device, train, stats, smi) -> None:
    """(t) training at scale on a one-rank NCCL group made in this process
    (destroyed at the end), the backward kernels on tiles, and two-rank
    spatial steps when there are two cards."""
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh

    store = tempfile.mkdtemp(prefix="smoke-nccl-")
    init_distributed("file://" + os.path.join(store, "store"), 1, 0, device_type="cuda")
    try:
        mesh = make_mesh()
        _spatial_steps(device, train, mesh, smi)
        _unet_dp_step(device, mesh, smi)
        _pix2pix_spatial_step(device, mesh, smi)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    _async_save(device, train, smi)
    _tile_kernels(device, stats, smi)
    if torch.cuda.device_count() < 2:
        print("[t] the (1, 1, 2) and (1, 2, 1) spatial steps need >= 2 cards; "
              f"{torch.cuda.device_count()} visible: not run")
        return
    from nasa_niswan_tpu_torch.parallel import launch

    out = launch.spawn(two_rank_spatial_phase, 2, "cuda", dict(
        grid=GRID, padded=PADDED, hidden=HIDDEN, kernels=KERNELS, bs=TRAIN_BS, T=TRAIN_T,
        dtype="bfloat16"), timeout=600)
    print(f"[t] two ranks on two cards: {out[0]}")
    check(all(v["grad_rel"] <= TOL_GRAD["bfloat16"] and v["loss_rel"] <= 1e-3
              and v.get("state_rel", 0.0) <= TOL_T_UNET
              for v in out[0].values()), f"[t] two-rank spatial steps {out[0]}")


def two_rank_spatial_phase(rank: int, size: dict) -> dict:
    """(t) on two ranks, one device each: the spatially sharded step on
    (1, 1, 2) and (1, 2, 1) meshes, on the ConvLSTM's remat, per-cell and
    hoisted routes (T_ROUTES) and for a UNet in f64 (its small width:
    features 4/8/16/32 on 32 x 64, which gathers before the fourth pool on
    (1, 2, 1)), against the single-device step on rank 0's device (loss
    and per-leaf gradients, relative to the leaf's largest; the UNet's
    running statistics beside them).  ``size`` gives the ConvLSTM's widths
    (the card's full width; small on the CPU)."""
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    grid, padded, T = tuple(size["grid"]), tuple(size["padded"]), size["T"]
    data = synthetic_e33oma_90d(T=2 * T + 8, H=grid[0], W=grid[1], seed=SEED)
    ds = SequenceDataset(data, period="train", sequence_length=T, in_channels=5)
    idx = np.arange(size["bs"]) % len(ds)
    x, y = (np.stack(a) for a in zip(*(ds[int(i)] for i in idx)))
    geo = dict(padded_shape=padded, grid_shape=grid)
    u_data = synthetic_e33oma_90d(T=24, H=24, W=40, seed=SEED)
    u_ds = SingleStepDataset(u_data, period="train")
    u_x, u_y = (np.stack(a).astype(np.float64) for a in zip(*(u_ds[i] for i in range(4))))
    u_geo = dict(padded_shape=(32, 64), grid_shape=(24, 40))
    unet = build_model("UNet-sp2", in_channels=5, unet_features=(4, 8, 16, 32))

    def single(b, p, norm=ds.normalizer, geo=geo):
        return make_train_step(b, norm, make_optimizer(p, 1e-3, (0.5, 0.999)), **geo)

    def step_grads(make, b, p, state, xb, yb):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        new_state, m = make(b, p)(p, state, xb, yb)
        return ([t.grad for t in param_leaves(p)], m["loss"].item(),
                [] if new_state is None else tree_leaves(new_state))

    out = {}
    for dims in ((1, 1, 2), (1, 2, 1)):
        mesh = make_mesh(*dims)

        def sharded(b, p, mesh=mesh, norm=ds.normalizer, geo=geo):
            return make_spatial_train_step(b, norm, make_optimizer(p, 1e-3, (0.5, 0.999)),
                                           mesh, **geo)

        for route, opts in T_ROUTES:
            bundle = build_model("LSTM-sp2", in_channels=5,
                                 hidden_channels=tuple(size["hidden"]),
                                 kernel_sizes=tuple(size["kernels"]),
                                 compute_dtype=size["dtype"], **opts)
            init, _ = bundle.init(torch.Generator().manual_seed(SEED), mesh.device)
            g, loss, _ = step_grads(sharded, bundle, init, None, x, y)
            if rank == 0:
                g1, loss1, _ = step_grads(single, bundle, init, None, x, y)
                out[f"{dims}/{route}"] = dict(loss_rel=abs(loss - loss1) / abs(loss1),
                                              grad_rel=max(_leaf_rel(g, g1)))
        p0, s0 = unet.init(torch.Generator().manual_seed(SEED), mesh.device)
        p0, s0 = (tree_map(lambda t: t.double(), t) for t in (p0, s0))
        sp = lambda b, p: sharded(b, p, norm=u_ds.normalizer, geo=u_geo)  # noqa: E731
        g, loss, st = step_grads(sp, unet, p0, s0, u_x, u_y)
        if rank == 0:
            one = lambda b, p: single(b, p, norm=u_ds.normalizer, geo=u_geo)  # noqa: E731
            g1, loss1, st1 = step_grads(one, unet, p0, s0, u_x, u_y)
            paths = tree_paths(p0)
            keep = [i for i, path in enumerate(paths) if not path.endswith(UNET_NOISE)]
            out[f"{dims}/unet-f64"] = dict(
                loss_rel=abs(loss - loss1) / abs(loss1),
                grad_rel=max(_leaf_rel([g[i] for i in keep], [g1[i] for i in keep])),
                state_rel=max(_leaf_rel(st, st1)))
    return out


def two_rank_replay_phase(rank: int, size: dict) -> dict:
    """(w) on two ranks, one device each: the data-parallel (dp = 2, each
    rank its half of the batch) and the spatially sharded (1, 1, 2) remat
    steps, three calls of each (on a card an eager step and the capture,
    then replays: NCCL's all-reduce and the halo messages inside the
    graph) against three calls of its eager body from the same weights.
    Whether losses and parameters are bit-equal, on every rank."""
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step

    grid, padded, T = tuple(size["grid"]), tuple(size["padded"]), size["T"]
    data = synthetic_e33oma_90d(T=2 * T + 8, H=grid[0], W=grid[1], seed=SEED)
    ds = SequenceDataset(data, period="train", sequence_length=T, in_channels=5)
    idx = np.arange(size["bs"]) % len(ds)
    x, y = (np.stack(a) for a in zip(*(ds[int(i)] for i in idx)))
    geo = dict(padded_shape=padded, grid_shape=grid)
    out = {}
    for name, dims in (("dp = 2", (2,)), ("(1, 1, 2)", (1, 1, 2))):
        mesh = make_mesh(*dims)
        bundle = build_model("LSTM-rp2", in_channels=5, hidden_channels=tuple(size["hidden"]),
                             kernel_sizes=tuple(size["kernels"]), compute_dtype=size["dtype"])
        init, _ = bundle.init(torch.Generator().manual_seed(SEED), mesh.device)
        h = x.shape[0] // 2
        xb, yb = (x[rank * h:(rank + 1) * h], y[rank * h:(rank + 1) * h]) if len(dims) == 1 \
            else (x, y)
        runs = []
        for eager in (False, True):
            p = tree_map(lambda t: t.detach().clone().requires_grad_(True), init)
            opt = make_optimizer(p, 1e-3, (0.5, 0.999))
            step = (make_train_step(bundle, ds.normalizer, opt, mesh=mesh, **geo)
                    if len(dims) == 1 else
                    make_spatial_train_step(bundle, ds.normalizer, opt, mesh, **geo))
            fn = step.eager if eager else step
            losses = [fn(p, None, xb, yb)[1]["loss"].item() for _ in range(3)]
            runs.append((losses, [t.detach().clone() for t in param_leaves(p)]))
            del step, opt
        (lg, pg), (le, pe) = runs
        out[name] = lg == le and all(torch.equal(a, b) for a, b in zip(pg, pe))
    return out


# (u) configs #1-#4's campaigns at full width: only steps and epochs cut
U_RUNS = (
    ("torch_run_northstar_year", ["--steps", "2880", "--block", "1440", "--chunk", "480"]),
    ("torch_run_train_year", ["--steps", "2880", "--epochs", "2"]),
    ("torch_run_seq2seq_protocol", ["--epochs", "1"]),
    ("torch_run_year_rollout", ["--steps", "2880", "--train-days", "10", "--epochs", "1",
                                "--chunk", "480"]),
    # 720 of the script's 1440 steps: the whole script's time paid for (p)'s C1 and (x)
    ("torch_run_results_r02", ["--steps", "720", "--epochs", "1", "--epochs-b", "1"]),
)
U_TRAINS = ("convlstm_cell", "cell_bwd", "conv_same")  # launched by every training run


def _example(name: str):
    """examples/<name>.py imported as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _campaign_run(tag: str, run, trains: bool = True, exact=None, show=None, phase="u"):
    """``run()`` with every count set to 0 just before it and read just
    after: every number of its result (``show(result)`` when given) finite
    and, for a run that trains, B1 (plain), B2 and B3 launched;
    ``exact(result)``, when given, names the exact launches of each kernel
    (``_expect_counts``).  Adds the counts to LAUNCHED; returns the result
    and the counts.  ``phase`` names the phase in the printed lines."""
    _elapsed(f"({phase}) {tag}")
    _set_counts(0)
    t0 = time.perf_counter()
    res = run()
    secs = time.perf_counter() - t0
    shown = res if show is None else show(res)
    if exact is not None:
        got = _expect_counts(f"[{phase}] {tag}", **exact(res))
    else:
        got = _counts()
        for name, n in got.items():
            LAUNCHED[name] += n
    print(f"[{phase}] {tag}: {secs:.1f} s, launches {got}: {json.dumps(shown)}")
    check(_finite(shown), f"[{phase}] {tag}: a number is not finite")
    if trains:
        check(all(got[k] > 0 for k in U_TRAINS),
              f"[{phase}] {tag}: B1, B2, B3 not all launched")
    return res, got


def _workers(*env) -> dict:
    """One worker process per ``env`` (its extra environment), joined over
    ``env://`` on NCCL; rank 0's JSON line."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, path, "--port", str(port), "--rank", str(r),
                               "--world-size", str(len(env)), "--device", "cuda"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, **e))
             for r, e in enumerate(env)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"[u] multihost worker failed:\n{out}\n{err[-3000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _multihost(device) -> None:
    """(u) scripts/torch_multihost_worker.py as one OS process joined through
    ``env://`` on NCCL (WORLD_SIZE 1): its DP step bit-equal (loss and the
    updated parameters) to ``make_train_step`` without a mesh on the same
    batch, its rollouts equal to the single-device ones; the two-process
    form only with two cards."""
    w = _script("torch_multihost_worker")
    _elapsed("(u) torch_multihost_worker, one process")
    got = _workers({})
    for key, n in got["launches"].items():  # the worker's kernel launches
        for name, (mod, attr) in COUNTERS.items():
            if key == f"{mod.__name__}.{attr}":
                LAUNCHED[name] += n
    loss, r2, params = w.run_dp_step(None, device=device)
    one = dict(loss=loss, r2=r2, dp_params_sha256=w.params_digest(params))
    one.update(zip(("pred_mean", "pred_std"), w.run_spatial_rollout(None, device=device)))
    one.update(zip(("fb_mean", "fb_std"), w.run_feedback_rollout(None, device=device)))
    print(f"[u] torch_multihost_worker --world-size 1 (env://, NCCL): {json.dumps(got)}; "
          f"in this process without a mesh: {json.dumps(one)}")
    check(_finite(got), "[u] multihost worker: a number is not finite")
    check(got["loss"] == one["loss"] and got["dp_params_sha256"] == one["dp_params_sha256"],
          "[u] the one-rank DP step is not bit-equal to make_train_step")
    for key in ("r2", "pred_mean", "pred_std", "fb_mean", "fb_std"):
        rel = abs(got[key] - one[key]) / max(abs(one[key]), 1e-30)
        check(rel <= 1e-6, f"[u] multihost {key}: {got[key]} vs {one[key]}")
    if torch.cuda.device_count() < 2:
        print("[u] the two-process worker needs >= 2 cards; "
              f"{torch.cuda.device_count()} visible: not run")
        return
    _elapsed("(u) torch_multihost_worker, two processes")
    two = _workers({"CUDA_VISIBLE_DEVICES": "0"}, {"CUDA_VISIBLE_DEVICES": "1"})
    print(f"[u] torch_multihost_worker --world-size 2 on two cards: {json.dumps(two)}")
    for key in ("loss", "r2", "pred_mean", "pred_std", "fb_mean", "fb_std"):
        rel = abs(two[key] - one[key]) / max(abs(one[key]), 1e-30)
        check(rel <= 1e-6, f"[u] two-process {key}: {two[key]} vs {one[key]}")


def phase_campaigns(device, smi) -> None:
    """(u) configs #1-#4's campaign scripts (U_RUNS), both examples at their
    defaults (the quickstart without figures) and the multi-host worker,
    at full width; each run's counts read from 0, every number it writes
    finite, B1/B2/B3 launched where it trains, the north-star year's B1
    launches exact."""
    root = tempfile.mkdtemp(prefix="niswan_campaigns_")
    n_layers = len(HIDDEN)
    try:
        for name, flags in U_RUNS:
            out = os.path.join(root, name)
            if name == "torch_run_train_year":
                flags = [*flags, "--snapshot-dir", os.path.join(out, "snap"),
                         "--out", os.path.join(out, "results.json")]
            else:
                flags = [*flags, "--out", out]
            kw = {}
            if name == "torch_run_northstar_year":
                # the warm-up request (one eager step, then the captured
                # chunk replayed), then the year
                kw = dict(trains=False, exact=lambda r: dict(
                    convlstm_cell=n_layers * (1 + r["chunk"] + r["steps"])))
            res, got = _campaign_run(f"{name} {' '.join(flags)} (on {smi})",
                                     lambda: _script(name).main(flags), **kw)
            if name == "torch_run_northstar_year":
                print(f"[u] northstar year: {res['model_days_per_min']:.1f} model-days/min, "
                      f"{res['chunk_ms']:.3f} ms a chunk of {res['chunk']} steps, its input "
                      f"copy {res['chunk_copy_in_ms']} ms; B1 launches in the year "
                      f"{res['b1_plain_launches']} (want {n_layers} x {res['steps']})")
                check(res["b1_plain_launches"] == n_layers * res["steps"],
                      "[u] northstar year: B1 launches != 3 x steps")
            elif name == "torch_run_train_year":
                want = n_layers * 48 * res["optimizer_steps"]
                check(got["cell_bwd"] == want and got["conv_same"] == want,
                      f"[u] train year: B2 / B3 launches != 3 x 48 x steps ({want})")
        qs = os.path.join(root, "quickstart")
        _campaign_run(
            f"examples/torch_quickstart.py --no-figures (on {smi})",
            lambda: _example("torch_quickstart").main(["--no-figures", "--outdir", qs]),
            show=lambda r: dict(r["report"]["temporal_r2_summary"],
                                global_r2=r["report"]["global_r2"],
                                sensitivity=r["sensitivity"], logger=r["logger"]))
        check(os.path.isfile(os.path.join(qs, "test-results.npy")), "[u] quickstart results")
        sv, _ = _campaign_run(
            f"examples/torch_serving.py (on {smi})",
            lambda: _example("torch_serving").main(["--outdir", os.path.join(root, "serving")]),
            show=lambda r: dict(steps=int(r["preds"].shape[0]),
                                pred_mean=float(r["preds"].mean()),
                                artifact_bytes=os.path.getsize(r["artifact"])))
        with torch.inference_mode():
            want, _ = make_rollout_fn(sv["config"], sv["normalizer"], padded_shape=sv["padded"],
                                      grid_shape=sv["preds"].shape[1:])(
                sv["params"], sv["frames"][None])
        want = want[0].cpu().numpy()
        d = float(np.abs(sv["preds"] - want).max() / np.abs(want).max())
        print(f"[u] served chunks vs one rollout: max|d|/max {d:.3e}")
        check(np.isfinite(sv["preds"]).all() and d <= 1e-6, "[u] served chunks != rollout")
        _multihost(device)
        print("[u] every training step of these runs is a graph replay (graph.py), "
              "timed by the runs themselves; their eager bodies' ms/step are (h)'s, (j)'s, "
              "(l)'s and (m)'s and (w)'s, on the same card")
    finally:
        shutil.rmtree(root, ignore_errors=True)


V_STEPS = 48  # serving steps of (v)'s rollout, closed loop and shootout runs
V_TRACE_STEPS = 24  # the traced serving replay


def _positive(values: dict, what: str) -> None:
    """Every value finite and > 0."""
    for key, v in values.items():
        check(v is not None and bool(np.isfinite(v)) and v > 0, f"[v] {what}: {key} = {v}")


def _times(res: dict) -> dict:
    """The numbers of ``res`` that are times or rates: keys that begin with
    ms_ or end in ms, _s or per_min."""
    return {k: v for k, v in res.items() if isinstance(v, float)
            and (k.startswith("ms_") or k.endswith(("ms", "_s", "per_min")))}


def _summary_ok(summary: dict, b1_launches: int, what: str) -> None:
    """A trace summary of the card: B1's launches exactly ``b1_launches``,
    the sustained rate's share of the bf16 peak in (0, 1]."""
    frac = summary["fraction_of_bf16_peak"]
    check(frac is not None and 0 < frac <= 1, f"[v] {what}: fraction_of_bf16_peak {frac}")
    print(f"[v] {what} trace summary: B1 launches {summary['launches']['b1']} (want "
          f"{b1_launches}), device {summary['device_ms_per_step']:.4f} ms/step, "
          f"{summary['sustained_tflops']:.1f} TFLOP/s, {frac:.4f} of the bf16 peak; "
          f"B1 by layer {json.dumps(summary['b1_layers'])}")
    check(summary["launches"]["b1"] == b1_launches,
          f"[v] {what}: the trace holds {summary['launches']['b1']} B1 launches")


def phase_profiles(device, smi) -> None:
    """(v) the profiling and benchmark scripts at a cut size (steps, reps,
    the train fixture's length, the day files' steps): each run's counts
    read from 0, every number finite and every time positive; the traced
    serving replay and closed-loop chunk hold exactly 3 B1 launches a step
    in their trace summaries, and each summary's share of the bf16 peak is
    in (0, 1]; the shootout's kernel-vs-plain parity within its 0.05; the
    native netCDF reader equal to scipy."""
    root = tempfile.mkdtemp(prefix="niswan_profiles_")
    n_layers = len(HIDDEN)
    try:
        flags = ["--steps", str(V_STEPS), "--reps", "1", "--trace", os.path.join(root, "ro"),
                 "--trace-steps", str(V_TRACE_STEPS), "--summary",
                 os.path.join(root, "ro.json")]
        res, got = _campaign_run(
            f"torch_profile_rollout {' '.join(flags[:6])} (on {smi})",
            lambda: _script("torch_profile_rollout").main(flags), trains=False,
            show=lambda r: {k: r[k] for k in ("ms_per_step", "span_ms_per_step",
                                              "device_ms_per_step")},
            phase="v")
        check(got["convlstm_cell"] > 0 and got["convlstm_cell_xg"] > 0
              and got["conv_same"] > 0, "[v] rollout: B1 plain, B1 xg and B3 not all launched")
        _positive(res["ms_per_step"], "rollout ms/step")
        _positive(res["span_ms_per_step"], "rollout device span ms/step")
        _positive(res["device_ms_per_step"], "rollout device ms/step")
        _summary_ok(res["summary"], n_layers * V_TRACE_STEPS, "full_scan replay")

        flags = ["--steps", str(V_STEPS), "--chain", "2", "--trace", os.path.join(root, "cl"),
                 "--summary", os.path.join(root, "cl.json")]
        res, _ = _campaign_run(
            f"torch_profile_closed_loop {' '.join(flags[:4])} (on {smi})",
            lambda: _script("torch_profile_closed_loop").main(flags), trains=False,
            show=lambda r: {k: r[k] for k in ("ms_per_step", "model_days_per_min")},
            phase="v")
        _positive(_times(res), "closed loop")
        _summary_ok(res["summary"], n_layers * V_STEPS, "closed-loop chunk")

        flags = ["--T", "48", "--batch", "4", "--reps", "3"]
        res, got = _campaign_run(f"torch_profile_seq2seq {' '.join(flags)} (on {smi})",
                                 lambda: _script("torch_profile_seq2seq").main(flags),
                                 phase="v")
        check(got["convlstm_cell_gates"] > 0 and got["conv_dw"] > 0,
              "[v] seq2seq: the per-cell route's B1 emit_gates and dW not launched")
        _positive(_times(res), "seq2seq")
        # the pad's share is finite; its sign is not held: on the host clock
        # two timings of one route spread wider than the share (PERF.md §6)
        check(all(bool(np.isfinite(res[k])) and -1 < res[k] < 1
                  for k in ("pad_share", "pad_share_fused")), f"[v] seq2seq pad_share {res}")

        bench = _script("torch_bench_cell")
        flags = ["--steps", str(V_STEPS), "--reps", "1", "--parity"]
        res, got = _campaign_run(f"torch_bench_cell {' '.join(flags)} (on {smi})",
                                 lambda: bench.main(flags), trains=False, phase="v")
        par = res["rows"][0]
        check(par["max_rel_pred"] <= bench.PARITY_REL,
              f"[v] shootout parity {par['max_rel_pred']} > {bench.PARITY_REL}")
        for row in res["rows"][1:]:
            _positive(_times(row), f"shootout {row['impl']}")
        bench = _script("torch_bench_cell")
        bench.TRAIN_T = 8
        flags = ["--train", "--train-batches", "4", "--train-steps", "1"]
        res, _ = _campaign_run(f"torch_bench_cell {' '.join(flags)}, T {bench.TRAIN_T} "
                               f"(on {smi})", lambda: bench.main(flags), phase="v")
        _positive(_times(res["rows"][0]), "shootout --train")

        nc = _script("torch_bench_ncread")
        nc.STEPS_PER_DAY, nc.REPS, nc.SAMPLES = 8, 2, 16
        res, _ = _campaign_run(f"torch_bench_ncread, {nc.STEPS_PER_DAY} steps a day",
                               lambda: nc.main([]), trains=False, phase="v")
        check(res["native_equals_scipy"] is True, "[v] native reader != scipy")
        _positive(_times(res), "ncread")

        prof = _script("profile_torch_train_step")
        prof.DATA_T = 240
        flags = ["--routes", "remat", "--reps", "1", "--steps", "1"]
        res, _ = _campaign_run(
            f"profile_torch_train_step {' '.join(flags)}, fixture T {prof.DATA_T} (on {smi})",
            lambda: prof.main(flags), show=lambda r: r["remat"], phase="v")
        _positive(res["remat"], "train step")
        want = n_layers * prof.SEQ
        s = res["profile"]["summary"]
        check(s["launches"]["b2a"] == want, f"[v] remat step trace: B2 (a) {s['launches']}")
        _summary_ok(s, want, "remat training step")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_profiles_fresh(smi) -> None:
    """(v) in a Python process of its own, as a user runs the scripts: in
    this process, after the phases before it, a torch.profiler session
    over a graph replay recorded only part of its kernels (67 of 72 B1
    launches; kernel sums 12-72% short), where a new process records all
    of them.  Its launches stay out of LAUNCHED."""
    torch.cuda.empty_cache()
    sys.stdout.flush()
    code = ("import torch, chip_smoke as cs; "
            f"cs.phase_profiles(torch.device('cuda', 0), {smi!r})")
    proc = subprocess.run([sys.executable, "-c", code], timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"[v] the profiling scripts' phase exited {proc.returncode}")


_T0 = time.perf_counter()


# (w) training as CUDA graphs: each step function of the port from one set
# of weights, W_CALLS calls graphed (the first an eager step and the
# capture, the rest replays) against W_CALLS calls of its eager body; the
# lr is set to W_LR before the third call (a StepLR change inside one
# capture)
W_CALLS = 4
W_LR = 5e-4
W_SERVE_T = 8  # steps of the serving request made before and after the replays


def _free_graphs() -> None:
    """Free the graphs (and their private pools) that went out of scope."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _w_copy(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def _w_err(got, want) -> float:
    """max over leaves of max |g - w| / max |w|; 0.0 when every leaf is
    bit-equal."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max().item()
            s = w.double().abs().max().item()
            worst = max(worst, d / s if s else float("inf"))
    return worst


def _w_route(tag, make, call, init, smi, *, state=None, gen=None, tol=None, calls=W_CALLS,
             captures=1, hook=None) -> dict:
    """(w) one step function, graphed and eager, each from a copy of
    ``init`` (and of the model ``state``): ``make(params) -> (step,
    optimizers)``, ``call(fn, params, i, state, gen) -> (state, metrics)``
    with ``fn`` the step or its ``.eager``; ``gen()`` makes the generator
    the calls draw from.  ``hook(mode, params, optimizers, step, i)`` runs
    before call i and, with i == calls, after the runs are compared.
    Holds parameters, optimizer state (Adam's step and moments), model
    state and metrics bit-equal (``tol`` None) or per leaf within ``tol``,
    and the step's captures.  Returns host ms/step (graph, eager), the
    replay's device span, peak GiB and the first call's host ms."""
    runs, info, n_cap, captured = {}, {}, None, set()
    for mode in ("graph", "eager"):
        p = _w_copy(init)
        step, opts = make(p)
        g = None if gen is None else gen()
        fn = step if mode == "graph" else step.eager
        st = None if state is None else _w_copy(state)
        _free_graphs()
        torch.cuda.reset_peak_memory_stats()
        host, span, metrics = [], [], []
        for i in range(calls):
            if i == 2:
                for o in opts:
                    set_learning_rate(o, W_LR)
            if hook is not None:
                hook(mode, p, opts, step, i)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            n0 = step.runner.captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            st, m = call(fn, p, i, st, g)
            e1.record()
            torch.cuda.synchronize()
            host.append(1000 * (time.perf_counter() - t0))
            span.append(e0.elapsed_time(e1))
            metrics.append(m)
            if step.runner.captures > n0:
                captured.add(i)
        # the calls that replayed (in both modes, the same calls)
        kept = [i for i in range(calls) if i not in captured]
        info[mode] = dict(host=float(np.mean([host[i] for i in kept])),
                          span=float(np.mean([span[i] for i in kept])),
                          peak=torch.cuda.max_memory_allocated() / 2**30, first=host[0])
        runs[mode] = (
            [t.detach().clone() for t in tree_leaves(p)]
            + [t.clone() for o in opts for t in optimizer_leaves(o)],
            [t.detach().clone() for t in tree_leaves(st)],
            [torch.stack([m[k].float() for m in metrics]) for k in sorted(metrics[0])])
        if hook is not None:
            hook(mode, p, opts, step, calls)
        if mode == "graph":
            n_cap = step.runner.captures
        del step, opts, p, st, fn, g, metrics
    _free_graphs()
    errs = [_w_err(a, b) for a, b in zip(runs["graph"], runs["eager"])]
    held = max(errs) == 0.0 if tol is None else max(errs) <= tol
    gi, ei = info["graph"], info["eager"]
    print(f"[w] {tag}: {calls} calls graphed vs eager, lr {W_LR:g} from call 3: "
          + ("bit-equal (parameters, Adam's step and moments, state, metrics)"
             if max(errs) == 0.0 else
             f"max |d| / max |eager| per leaf: parameters and Adam {errs[0]:.3e}, state "
             f"{errs[1]:.3e}, metrics {errs[2]:.3e} (tol {tol})")
          + f"; captures {n_cap} (want {captures}); ms/step replay {gi['host']:.2f} host, "
          f"{gi['span']:.2f} device span (CUDA events), eager {ei['host']:.2f} host; first "
          f"call (eager step + capture) {gi['first']:.1f} ms; peak {gi['peak']:.2f} GiB "
          f"graphed, {ei['peak']:.2f} eager on {smi}")
    check(held and n_cap == captures, f"[w] {tag}: errors {errs}, captures {n_cap}")
    return info


def _w_profile(step, p, batch, smi) -> None:
    """(w) one replayed remat step under the profiler: B1, B2 (a), B2's dW
    and B3 launches by kernel name equal to the runner's counters, and
    each kernel's device time per launch under replay."""
    step(p, None, batch)
    torch.cuda.synchronize()
    _set_counts(0)
    _, names = _profile(lambda: step(p, None, batch))
    runner = _counts()
    by = {}
    for key, (n, ms) in names.items():
        if "cell_wgmma_kernel" in key or "cell_fp32_kernel" in key:
            cls = "B2 (a)" if "BackwardEpi" in key else "B1"
        elif "dw_mma_kernel" in key:
            cls = "dW"
        elif "conv_same_mma_kernel" in key or "conv_same_fp32_kernel" in key:
            cls = "B3"
        else:
            continue
        layer = re.search(r"_kernel(?:_wgmma)?<(\d+), ?(\d+)", key)
        sub = f"k {layer.group(1)}, {layer.group(2)}" if layer else ""
        c, t = by.get((cls, sub), (0, 0.0))
        by[cls, sub] = (c + n, t + ms)
    total = {cls: sum(n for (c, _), (n, _) in by.items() if c == cls)
             for cls in ("B1", "B2 (a)", "dW", "B3")}
    for (cls, sub), (n, ms) in sorted(by.items()):
        print(f"[w] replayed remat step, {cls} {sub}: {n} launches, {ms:.3f} ms, "
              f"{ms / n:.4f} ms per launch (profiler) on {smi}")
    want = dict(B1=runner["convlstm_cell"], **{"B2 (a)": runner["cell_bwd"]},
                dW=runner["cell_bwd"], B3=runner["conv_same"])
    print(f"[w] one replayed remat step: launches by kernel name {total}, by the runner's "
          f"counters {want}")
    check(total == want and total["B1"] == len(HIDDEN) * TRAIN_T,
          f"[w] profiler {total} vs runner {want}")


def phase_train_graphs(device, train, smi) -> None:
    """(w) every training and evaluation step function replayed as a CUDA
    graph against its eager body (``step.eager``), at full width: the
    canonical step on the remat, per-cell and hoisted routes, config #2
    (C = 62) and config #3 (both routes), the UNet, the pix2pix generator
    and the GAN step (cuDNN's deterministic algorithms: within
    TOL_T_UNET), the eval steps; on the remat step an async save
    before the lr change, a restore then replays, a serving graph made
    between replays that sees the trained weights, and one replay under
    the profiler; DP and the spatially sharded steps on a one-rank NCCL
    group."""
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_eval_step
    from nasa_niswan_tpu_torch.train.checkpoint import load_optimizer_state, optimizer_state
    from nasa_niswan_tpu_torch.train.checkpoint_async import AsyncCheckpointer
    from nasa_niswan_tpu_torch.train.loop import make_device_eval_step

    src, ds, geo, init, kw = (train[k] for k in ("src", "ds", "geo", "init", "kw"))
    order = train["order"]
    starts = [order[s * TRAIN_BS:(s + 1) * TRAIN_BS] for s in range(8)]
    adam = (1e-3, (0.5, 0.999))
    root = tempfile.mkdtemp(prefix="niswan_graphs_")

    def device_step(bundle, mesh=None):
        def make(p):
            opt = make_optimizer(p, *adam)
            return make_device_train_step(bundle, ds.normalizer, opt, src, mesh=mesh,
                                          **geo), (opt,)
        return make

    def windows(fn, p, i, st, g):
        return fn(p, None, starts[i])

    # --- the remat step, with the save, the restore, serving and the profile
    bundle = build_model("LSTM-smoke", **kw)
    serve = {}
    forcings = src.gather(starts[7][:1])[0][:, :W_SERVE_T]

    def remat_hook(mode, p, opts, step, i):
        if mode == "graph" and i == 1:  # a serving graph made after the step's capture
            serve["fn"] = make_rollout_fn(bundle.config, ds.normalizer, padded_shape=PADDED,
                                          grid_shape=GRID, static=geo["static"])
            serve["before"] = serve["fn"](p, forcings)[0]
        if mode == "graph" and i == 4:  # after three replays, before the restore
            after = serve["fn"](p, forcings)[0]
            want = serve["fn"].eager(p, forcings)[0]
            print(f"[w] a serving graph captured after call 1, served again after replays "
                  f"2-4: recaptured ({serve['fn'].runner.captures} captures), equal to the "
                  f"eager rollout on the trained weights "
                  f"{'bit for bit' if torch.equal(after, want) else 'NOT'}, moved "
                  f"{(after - serve['before']).abs().max().item():.3e}")
            check(serve["fn"].runner.captures == 2 and torch.equal(after, want)
                  and not torch.equal(after, serve["before"]),
                  "[w] the serving graph did not see the trained weights")
            serve.clear()
        if i == 2:  # an async save between replays, then the lr change
            ckpt = AsyncCheckpointer(os.path.join(root, mode), max_to_keep=1)
            ckpt.save(2, p, opts[0], learning_rate=W_LR)
            ckpt.close()
        if i == 4:  # a restore: new optimizer tensors, so the next call recaptures
            load_optimizer_state(opts[0], p, optimizer_state(opts[0], p))
        if mode == "graph" and i == W_CALLS + 2:
            _w_profile(step, p, starts[0], smi)

    info = {"remat": _w_route("remat step (make_device_train_step; an async save before "
                              "call 3, a restore before call 5)", device_step(bundle),
                              windows, init, smi, calls=W_CALLS + 2, captures=2,
                              hook=remat_hook)}
    shutil.rmtree(root, ignore_errors=True)
    for route, opts in T_ROUTES[1:]:
        info[route] = _w_route(f"{route} step", device_step(build_model(
            "LSTM-smoke", **opts, **kw)), windows, init, smi)

    # --- the eval steps -------------------------------------------------------
    ev = make_device_eval_step(bundle, ds.normalizer, src, **geo)
    got = [ev(init, None, starts[i]) for i in range(3)]
    want = [ev.eager(init, None, starts[i]) for i in range(3)]
    same = all(torch.equal(a, b) for g_, w_ in zip(got, want) for a, b in zip(g_, w_))
    print(f"[w] eval step (make_device_eval_step), 3 calls: "
          f"{'bit-equal to' if same else 'DIFFER from'} its eager body, "
          f"{ev.runner.captures} capture")
    check(same and ev.runner.captures == 1, "[w] eval step")
    del ev, got, want

    # --- config #2: C = 62 host batches through make_train_step ---------------
    gen = torch.Generator(device=device).manual_seed(SEED)
    x2 = torch.randn((TRAIN_BS, TRAIN_T, C, *GRID), generator=gen, device=device)
    y2 = torch.rand((TRAIN_BS, *GRID), generator=gen, device=device)
    norm2 = Normalizer(np.zeros(C, np.float32), np.ones(C, np.float32), 0.0, 1.0)
    b2 = build_model("LSTM-c2", **dict(kw, in_channels=C))
    init2 = _copy_params(b2.init(torch.Generator().manual_seed(SEED), device)[0])

    def make2(p):
        opt = make_optimizer(p, *adam)
        return make_train_step(b2, norm2, opt, padded_shape=PADDED, grid_shape=GRID), (opt,)

    info["config #2"] = _w_route("config #2 remat step (C = 62, make_train_step)", make2,
                                 lambda fn, p, i, st, g: fn(p, None, x2, y2), init2, smi)
    del x2, y2, init2

    # --- config #3: both routes, draws from a CPU generator ---------------------
    x3 = torch.randn((TRAIN_BS, TRAIN_T, S2S_C - 1, *GRID), generator=gen, device=device)
    p03 = torch.rand((TRAIN_BS, *GRID), generator=gen, device=device)
    y3 = torch.rand((TRAIN_BS, TRAIN_T, *GRID), generator=gen, device=device)
    norm3 = Normalizer(np.zeros(S2S_C - 1, np.float32), np.ones(S2S_C - 1, np.float32),
                       0.0, 1.0)
    cfg3 = ConvLSTMConfig(in_channels=S2S_C, hidden_channels=HIDDEN, kernel_sizes=KERNELS,
                          compute_dtype="bfloat16")
    init3 = _copy_params(convlstm_init(torch.Generator().manual_seed(SEED), cfg3,
                                       device=device))
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg3, remat=remat)

        def make3(p, rcfg=rcfg):
            opt = make_optimizer(p, *adam)
            return make_seq2seq_train_step(rcfg, norm3, opt, padded_shape=PADDED,
                                           grid_shape=GRID), (opt,)

        route = "whole-chunk BPTT" if remat else "per-cell"
        info[f"config #3 {route}"] = _w_route(
            f"config #3 {route} step (make_seq2seq_train_step, draws from a seeded CPU "
            f"generator before each call)", make3,
            lambda fn, p, i, st, g: (None, fn(p, x3, p03, y3, g, 0.5)), init3, smi,
            gen=lambda: torch.Generator().manual_seed(SEED))
    ev3 = make_seq2seq_eval_step(cfg3, norm3, padded_shape=PADDED, grid_shape=GRID)
    got, want = ev3(init3, x3, p03, y3), ev3.eager(init3, x3, p03, y3)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"[w] config #3 eval step: {'bit-equal to' if same else 'DIFFERS from'} its "
          f"eager body")
    check(same, "[w] config #3 eval step")
    del x3, p03, y3, init3, ev3, got, want

    # --- the single-step families (f32, TF32 off; cuDNN) -------------------------
    x5 = torch.rand((R_BS, 5, *GRID), generator=gen, device=device)
    y5 = torch.rand((R_BS, *GRID), generator=gen, device=device)
    norm5 = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    unet = build_model("UNet-w", in_channels=5, unet_features=R_FEATS)
    pix = build_model("PIX2PIX-w", in_channels=5, pix2pix_features=R_PIX_FEATS)
    u0, us0 = unet.init(torch.Generator().manual_seed(SEED), device)
    g0, _ = pix.init(torch.Generator().manual_seed(SEED), device)
    rgeo = dict(padded_shape=R_PADDED, grid_shape=GRID)

    def family(b, mesh=None):
        def make(p):
            opt = make_optimizer(p, *adam)
            if mesh is None:
                return make_train_step(b, norm5, opt, **rgeo), (opt,)
            return make_spatial_train_step(b, norm5, opt, mesh, **rgeo), (opt,)
        return make

    def single(fn, p, i, st, g):
        return fn(p, st, x5, y5, rng=g)

    cuda_gen = lambda: torch.Generator(device=device).manual_seed(SEED)  # noqa: E731
    # cuDNN's deterministic algorithms for the families: with the others a
    # weight gradient sums in another order on every call, and Adam turns
    # the noise of the conv biases ahead of a norm (zero gradient) into
    # steps of the lr's size, so two runs of either kind part at once
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    info["UNet"] = _w_route("UNet step (BatchNorm state threaded)", family(unet), single,
                            u0, smi, state=us0, tol=TOL_T_UNET)
    info["pix2pix"] = _w_route("pix2pix generator step (dropout from a registered "
                               "generator)", family(pix), single, g0, smi, gen=cuda_gen,
                               tol=TOL_T_UNET)
    dcfg = DiscriminatorConfig(in_channels=1, features=R_FEATS)
    d0 = discriminator_init(torch.Generator().manual_seed(SEED), dcfg, device=device)
    for t in tree_leaves(d0):
        t.requires_grad_(True)
    xg = torch.rand((R_BS, *R_PADDED, 5), generator=gen, device=device)
    yg = torch.rand((R_BS, *R_PADDED, 1), generator=gen, device=device)

    def make_gan(p):
        opts = (make_optimizer(p[0], 2e-4, (0.5, 0.999)),
                make_optimizer(p[1], 2e-4, (0.5, 0.999)))
        return make_gan_train_step(pix.config, dcfg, *opts), opts

    info["GAN"] = _w_route("GAN step (two Adams, both networks)", make_gan,
                           lambda fn, p, i, st, g: (None, fn(p[0], p[1], xg, yg, g)),
                           (g0, d0), smi, gen=cuda_gen, tol=TOL_T_UNET)
    del xg, yg, d0
    torch.backends.cudnn.deterministic = deterministic

    # --- DP and the spatially sharded steps on a one-rank NCCL group -----------
    store = tempfile.mkdtemp(prefix="smoke-nccl-")
    init_distributed("file://" + os.path.join(store, "store"), 1, 0, device_type="cuda")
    try:
        mesh = make_mesh()
        info["DP"] = _w_route("data-parallel remat step (1 rank, NCCL all-reduce captured)",
                              device_step(bundle, make_mesh()), windows, init, smi)
        smesh = make_mesh(1, 1, 1)
        batches = [src.gather(s) for s in starts[:W_CALLS]]

        def spatial(b):
            def make(p):
                opt = make_optimizer(p, *adam)
                return make_spatial_train_step(b, ds.normalizer, opt, smesh, **geo), (opt,)
            return make

        for route, opts in T_ROUTES:
            info[f"sharded {route}"] = _w_route(
                f"sharded {route} step (1, 1, 1)", spatial(build_model(
                    "LSTM-smoke", **opts, **kw)), lambda fn, p, i, st, g: fn(
                    p, None, *batches[i]), init, smi)
        torch.backends.cudnn.deterministic = True
        info["sharded UNet"] = _w_route("sharded UNet step (1, 1, 1)", family(unet, smesh),
                                        single, u0, smi, state=us0, tol=TOL_T_UNET)
        info["sharded pix2pix"] = _w_route("sharded pix2pix step (1, 1, 1)",
                                           family(pix, smesh), single, g0, smi,
                                           gen=cuda_gen, tol=TOL_T_UNET)
        del mesh, smesh, batches
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del u0, us0, g0, x5, y5
    _free_graphs()
    if torch.cuda.device_count() < 2:
        print(f"[w] the dp = 2 and (1, 1, 2) replays against their eager bodies need >= 2 "
              f"cards; {torch.cuda.device_count()} visible: not run")
    else:
        from nasa_niswan_tpu_torch.parallel import launch

        out = launch.spawn(two_rank_replay_phase, 2, "cuda", dict(
            grid=GRID, padded=PADDED, hidden=HIDDEN, kernels=KERNELS, bs=TRAIN_BS,
            T=TRAIN_T, dtype="bfloat16"), timeout=600)
        print(f"[w] two ranks on two cards, replays bit-equal to their eager bodies: "
              f"{out[0]}")
        check(all(out[0].values()), f"[w] two-rank replays {out[0]}")
    print("[w] summary, ms/step (replay host / replay device span / eager host), peak GiB: "
          + json.dumps({k: [round(v["graph"]["host"], 2), round(v["graph"]["span"], 2),
                            round(v["eager"]["host"], 2), round(v["graph"]["peak"], 2)]
                        for k, v in info.items()}))


def _elapsed(what: str) -> None:
    """Where the command's time goes: seconds since the start, per phase."""
    print(f"[time] {what} starts at {time.perf_counter() - _T0:.1f} s", flush=True)


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    device = torch.device("cuda", 0)
    _elapsed("phase_build")
    phase_build()
    _elapsed("phase_kernel_vs_plain")
    cell = phase_kernel_vs_plain(device)
    _elapsed("phase_serve")
    serve = phase_serve(device)

    n_steps = N_REQUESTS * STEPS
    for name, t in (("kernel", serve["t_kernel"]), ("plain", serve["t_plain"])):
        print(
            f"[e] {name} path: {model_days_per_min(n_steps, t):.2f} model-days/min, "
            f"{1000 * t / n_steps:.4f} ms/step over {n_steps} steps "
            f"(C={C}, B=1, bf16) on {smi}"
        )
    _elapsed("phase_backward")
    bwd = phase_backward(device)
    _elapsed("phase_train")
    train = phase_train(device)
    for name in ("kernel", "eager", "plain"):
        t = train[f"t_{name}"]
        days = TRAIN_STEPS * TRAIN_BS * TRAIN_T / 48.0
        print(
            f"[h] training, {name} path{' (graph replays)' if name != 'eager' else ''}: "
            f"{1000 * t / TRAIN_STEPS:.1f} ms/step, "
            f"{days / (t / 60.0):.2f} model-days/min over {TRAIN_STEPS} steps "
            f"(bs {TRAIN_BS}, T {TRAIN_T}, C={TRAIN_C}, bf16) on {smi}"
        )
    print(f"[h] training, kernel path: peak memory {train['peak'] / 2**30:.2f} GiB")
    _elapsed("phase_train_graphs")
    phase_train_graphs(device, train, smi)
    stats = dict(phase_modes(device, cell), convlstm_cell=cell, **bwd)
    _elapsed("phase_per_cell")
    phase_per_cell(device, train)
    _elapsed("phase_hoist")
    phase_hoist(device, serve, train, smi)
    _elapsed("phase_seq2seq")
    phase_seq2seq(device, smi)
    _elapsed("phase_config2")
    phase_config2(device, smi, stats)
    _elapsed("phase_streamed")
    phase_streamed(device, smi)
    _elapsed("phase_graph_serve")
    phase_graph_serve(device, serve, stats, smi)
    _elapsed("phase_clis")
    phase_clis(device)
    _elapsed("phase_train_cli")
    phase_train_cli(device)
    _elapsed("phase_multitracer")
    phase_multitracer(device, serve, smi)
    _elapsed("phase_single_step")
    phase_single_step(device, smi)
    _elapsed("phase_sharded")
    phase_sharded(device, serve, train, stats, smi)
    _elapsed("phase_train_at_scale")
    phase_train_at_scale(device, train, stats, smi)
    _elapsed("phase_campaigns")
    phase_campaigns(device, smi)
    _elapsed("phase_profiles")
    phase_profiles_fresh(smi)
    _elapsed("the summary")
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
