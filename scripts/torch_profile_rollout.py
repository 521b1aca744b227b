#!/usr/bin/env python3
"""Decompose the north-star rollout step time on the port, the twin of
scripts/profile_rollout.py.

    python scripts/torch_profile_rollout.py [--steps 384] [--impl kernel]
        [--trace DIR [--trace-steps 96] [--summary OUT]] [--device cuda]

bench.py's serving configuration (C = 62, the 20-level fusion; ConvLSTM
64/32/16, kernels 5/3/3; bf16; B = 1; padded 100 x 154), random weights
from seed 0, timed whole and in ablations, each row one CUDA graph replay
on a card (as the JAX rows are ``jit`` calls; dispatched eagerly the step
would measure the host):

* ``full_hoist`` / ``full_scan``: ``make_rollout_fn`` with the input conv
  hoisted or not (normalize, pad, cells, head tap, crop, unnormalize);
* ``cells_taps_hoist`` / ``cells_taps_scan`` / ``cells_notaps_hoist``:
  ``convlstm_apply`` alone on prepared (B, T, 100, 154, C) bf16 frames, with
  and without the per-step head taps, captured through
  ``graph.Graphed``;
* ``cells_notaps_hoist_L1`` / ``_L2``: the first one or two layers alone.

Each row: a warm-up call (the capture), then ``--reps`` calls on the host
clock, each synchronised (``ms_per_step``), the device's span of the same
calls from a CUDA event before each to one after it (``span_ms_per_step``:
the input copies, the replay and the gaps between its kernels), and one
more call under ``torch.profiler``, whose kernel device time is summed
(``device_ms_per_step``).  Host minus span is what the host adds around a
replay; span minus the kernel sum is the device idle inside it.
``--impl`` picks the cell: ``kernel`` (B1) or ``plain`` (its plain
PyTorch version); the JAX script's ``xla`` and ``pallas`` cells are
TPU-only.  ``--trace DIR`` traces the ``full_scan``
replay of the first ``--trace-steps`` steps into ``DIR/trace.json``;
``--summary OUT`` writes scripts/torch_trace_summary.py's summary of it.
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
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.graph import Graphed  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import (  # noqa: E402
    ConvLSTMConfig,
    convlstm_apply,
    convlstm_init,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    fused_cell_forward,
    fused_cell_forward_plain,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import (  # noqa: E402
    make_rollout_fn,
    serving_weights,
)
from nasa_niswan_tpu_torch.utils.profiling import trace  # noqa: E402

C = 3 * 20 + 2
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
CELL_FNS = {"kernel": fused_cell_forward, "plain": fused_cell_forward_plain}


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=384)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--impl", default="kernel", choices=sorted(CELL_FNS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--trace-steps", type=int, default=96)
    ap.add_argument("--summary", default=None,
                    help="write the trace's summary (torch_trace_summary) here")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    if args.summary and not args.trace:
        ap.error("--summary needs --trace")
    if args.trace and not 0 < args.trace_steps <= args.steps:
        ap.error("--trace-steps must be in 1..--steps")
    return args


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(run, steps: int, device):
    """Kernel device time per step of one ``run()`` (torch.profiler); None
    off the card."""
    if device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        sync(device)
    # kernels only: an op's CPU event also reports its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3 / steps


def timed(run, steps: int, reps: int, device):
    """(host ms/step over ``reps`` synchronised calls after a warm-up, the
    device span ms/step of those calls (CUDA events; None off the card),
    kernel device ms/step of one more)."""
    run()  # the capture
    sync(device)
    cuda = device.type == "cuda"
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)] if cuda else []
    t0 = time.perf_counter()
    for r in range(reps):
        if cuda:
            marks[r][0].record()
        run()
        if cuda:
            marks[r][1].record()
        sync(device)
    host = (time.perf_counter() - t0) / reps / steps * 1e3
    span = sum(a.elapsed_time(b) for a, b in marks) / reps / steps if cuda else None
    return host, span, device_ms(run, steps, device)


def cells_fn(cfg, taps: bool, hoist: bool, cell_fn):
    """``run(params, xs)``: ``convlstm_apply`` on prepared frames, one CUDA
    graph replay per call on a card (eager on the CPU)."""
    def body(params, weights, xs):
        out = convlstm_apply(params, xs, cfg, return_per_step=taps,
                             precompute_input_conv=hoist, cell_fn=cell_fn, weights=weights)
        return out if taps else (out,)

    runner = Graphed(body, weights=lambda p: serving_weights(p, cfg, hoist),
                     warm=lambda xs: [xs[0][:, :1]])  # one step

    def run(params, xs):
        with torch.inference_mode():
            return runner(params, xs)

    return run


def main(argv=None):
    args = _parse(argv)
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    card = ts.card(device)
    print(card, flush=True)
    T, B = args.steps, args.batch
    cell_fn = CELL_FNS[args.impl]
    norm = Normalizer(x_mean=np.zeros(C, np.float32), x_std=np.ones(C, np.float32),
                      y_mean=0.0, y_std=1.0)
    rng = np.random.default_rng(0)
    forcings = torch.as_tensor(
        rng.standard_normal((B, T, C, *GRID)).astype(np.float32), device=device)
    layers = dict(hidden_channels=HIDDEN, kernel_sizes=KERNELS, compute_dtype=DTYPE)
    full_cfg = ConvLSTMConfig(in_channels=C, **layers)
    params = convlstm_init(torch.Generator().manual_seed(0), full_cfg, device=device)
    out, span, dev = {}, {}, {}

    def report(name, times):
        out[name], span[name], dev[name] = times
        print(json.dumps({name: out[name], "span_ms_per_step": span[name],
                          "device_ms_per_step": dev[name]}), flush=True)

    geo = dict(padded_shape=PADDED, grid_shape=GRID, device=device, cell_fn=cell_fn)
    for label, hoist in (("full_hoist", True), ("full_scan", False)):
        r = make_rollout_fn(full_cfg, norm, precompute_input_conv=hoist, **geo)
        report(label, timed(lambda r=r: r(params, forcings), T, args.reps, device))

    # prepared frames: cells (+ taps) only, no normalize / pad / transpose
    xs_pre = torch.as_tensor(
        rng.standard_normal((B, T, *PADDED, C)).astype(np.float32),
        device=device).to(full_cfg.torch_dtype)

    def bare(cfg, p, taps, hoist):
        run = cells_fn(cfg, taps, hoist, cell_fn)
        return timed(lambda: run(p, xs_pre), T, args.reps, device)

    report("cells_taps_hoist", bare(full_cfg, params, True, True))
    report("cells_taps_scan", bare(full_cfg, params, True, False))
    report("cells_notaps_hoist", bare(full_cfg, params, False, True))

    # layer-prefix ablation (cells only, no taps, hoisted)
    for n in (1, 2):
        cfg_n = ConvLSTMConfig(in_channels=C, hidden_channels=HIDDEN[:n],
                               kernel_sizes=KERNELS[:n], compute_dtype=DTYPE)
        p_n = {"cells": params["cells"][:n],
               "head": convlstm_init(torch.Generator().manual_seed(1), cfg_n,
                                     device=device)["head"]}
        report(f"cells_notaps_hoist_L{n}", bare(cfg_n, p_n, False, True))

    result = {"impl": args.impl, "batch": B, "ms_per_step": out, "span_ms_per_step": span,
              "device_ms_per_step": dev, "steps": T, "card": card}
    if args.trace:
        r = make_rollout_fn(full_cfg, norm, **geo)
        f_tr = forcings[:, :args.trace_steps]
        r(params, f_tr)  # the capture, outside the trace
        sync(device)
        with trace(args.trace):
            r(params, f_tr)
            sync(device)
        print("trace written to", args.trace, flush=True)
        if args.summary:
            result["summary"] = ts.summarize_file(
                args.trace, steps=args.trace_steps, label=f"full_scan_{args.impl}",
                config="northstar", width=PADDED[1], batch=B, card=card)
            ts.write_json(result["summary"], args.summary)
            print(json.dumps(result["summary"]), flush=True)
    print(json.dumps({k: result[k] for k in ("impl", "batch", "ms_per_step", "span_ms_per_step",
                                             "device_ms_per_step")}), flush=True)
    ts.write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
