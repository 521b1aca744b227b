#!/usr/bin/env python3
"""Profile the closed-loop serving chunk on the port, the twin of
scripts/profile_closed_loop.py.

    python scripts/torch_profile_closed_loop.py [--steps 480] [--chain 1]
        [--impl kernel] [--trace DIR [--summary OUT]] [--device cuda]

Config #3's production mode: the model feeds its own previous prediction
back through the feedback channel, at the canonical surface shapes (6
channels: 5 meteorological + feedback; ConvLSTM 64/32/16, kernels 5/3/3;
bf16; B = 1), random weights from seed 0, the forcings resident on the
device.  ``evalx/evaluate.make_closed_loop_chunk`` serves the chunk, one
CUDA graph replay per call on a card.  After a warm-up call (the capture),
the best of three runs of ``--chain`` chunks chained through the carry,
synchronised once at the end: ``--chain 1`` is one dispatch's latency,
more the sustained rate.  Prints ms/step and model-days/min.  ``--impl``
picks the cell: ``kernel`` (B1) or ``plain``; the JAX script's ``auto``,
``xla`` and ``pallas`` cells are TPU-only.  ``--trace DIR`` traces one
chunk into ``DIR/trace.json``; ``--summary OUT`` writes
scripts/torch_trace_summary.py's summary of it (``--config closedloop6``).
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
from torch_profile_rollout import CELL_FNS, sync  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.evalx.evaluate import (  # noqa: E402
    make_closed_loop_chunk,
    zero_closed_loop_state,
)
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.utils.profiling import trace  # noqa: E402

MET = 5  # meteorological channels; the sixth is the feedback
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
DTYPE = "bfloat16"
REPS = 3


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=480)
    ap.add_argument("--impl", default="kernel", choices=sorted(CELL_FNS))
    ap.add_argument("--trace", default=None)
    ap.add_argument("--summary", default=None,
                    help="write the trace's summary (torch_trace_summary) here")
    ap.add_argument("--chain", type=int, default=1,
                    help="chunks chained through the on-device carry per "
                         "measurement (sync once at the end) — the decadal "
                         "runner's dispatch pattern; 1 = single-dispatch "
                         "latency, >1 = sustained serving rate")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    args = ap.parse_args(argv)
    if args.chain < 1:
        ap.error("--chain must be >= 1")
    if args.summary and not args.trace:
        ap.error("--summary needs --trace")
    return args


def main(argv=None):
    args = _parse(argv)
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    card = ts.card(device)
    print(card, flush=True)
    cfg = ConvLSTMConfig(MET + 1, HIDDEN, KERNELS, compute_dtype=DTYPE)
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    norm = Normalizer(np.zeros(MET, np.float32), np.ones(MET, np.float32), 0.0, 1.0)
    run = make_closed_loop_chunk(cfg, norm, padded_shape=PADDED, grid_shape=GRID,
                                 cell_fn=CELL_FNS[args.impl])
    rng = np.random.default_rng(0)
    T = args.steps
    met = torch.as_tensor(rng.standard_normal((T, MET, *GRID)).astype(np.float32),
                          device=device)
    prev0 = torch.as_tensor(rng.standard_normal((1, *GRID)).astype(np.float32),
                            device=device)
    st = zero_closed_loop_state(cfg, PADDED, device)

    out = run(params, st, prev0, met)
    out[1].cpu()  # warm-up and capture; sync on the small prev frame
    best = 1e9
    for _ in range(REPS):
        t0 = time.perf_counter()
        s, p = st, prev0
        for _ in range(args.chain):
            s, p, preds = run(params, s, p, met)
        p.cpu()  # one sync per chain: the replays queue asynchronously
        best = min(best, time.perf_counter() - t0)
    n = T * args.chain
    result = {"impl": args.impl, "chain": args.chain, "steps": T,
              "ms_per_step": best * 1000 / n,
              "model_days_per_min": n / 48 / (best / 60), "card": card}
    print(f"closed-loop impl={args.impl} chain={args.chain}: "
          f"{result['ms_per_step']:.3f} ms/step wall (device-resident) -> "
          f"{result['model_days_per_min']:.0f} model-days/min", flush=True)

    if args.trace:
        with trace(args.trace):
            out = run(params, st, prev0, met)
            sync(device)
        print(f"trace written under {args.trace}", flush=True)
        if args.summary:
            result["summary"] = ts.summarize_file(
                args.trace, steps=T, label=f"closed_loop_{args.impl}",
                config="closedloop6", width=PADDED[1], card=card)
            ts.write_json(result["summary"], args.summary)
            print(json.dumps(result["summary"]), flush=True)
    ts.write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
