"""What a request served once costs on one NVIDIA GPU, for the PyTorch port
of the checkout named by ``--root``.

On the card every serving loop is captured as a CUDA graph at its first
call per input shape (graph.py), so a request made once (a
test-period rollout, evaluation after an optimizer step) pays the capture.
The canonical C = 62 model (20-level fusion, hidden 64/32/16, kernels
5/3/3, 100x154 padded grid), random weights from seeds 0-2, bf16, B = 1,
forcings drawn on the card from seed 0.  For 48 steps (one request) and
864 (the test period of the 90-day dataset, 20% of 90 x 48 steps), a fresh
``make_rollout_fn`` is timed on the host clock, synchronised after each
call: one eager call, its first graph call (warm-up, capture, one replay),
and one replay.  Then the 3-species multi-tracer graph over 48 steps: its
first call and five replays (ms/step).  Prints one JSON line; run two
checkouts in turns (parent, change, change, parent) to compare them.

    python scripts/time_first_call.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import nasa_niswan_tpu_torch
    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
    from nasa_niswan_tpu_torch.rollout.multitracer import (
        make_multitracer_rollout,
        stack_params,
    )

    if not nasa_niswan_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {nasa_niswan_tpu_torch.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    C, GRID, PADDED = 62, (90, 144), (100, 154)
    dev = torch.device("cuda", 0)
    cfg = ConvLSTMConfig(in_channels=C, hidden_channels=(64, 32, 16),
                         kernel_sizes=(5, 3, 3), compute_dtype="bfloat16")
    norm = Normalizer(np.zeros(C, np.float32), np.ones(C, np.float32), 0.0, 1.0)
    params = [convlstm_init(torch.Generator().manual_seed(s), cfg, device=dev)
              for s in range(3)]
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(padded_shape=PADDED, grid_shape=GRID)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t0)

    # build the kernels and warm the eager path
    f = torch.randn((1, 4, C, *GRID), generator=gen, device=dev)
    make_rollout_fn(cfg, norm, device=dev, **kw).eager(params[0], f)
    out = {"root": root}
    for T in (48, 864):
        f = torch.randn((1, T, C, *GRID), generator=gen, device=dev)
        r = make_rollout_fn(cfg, norm, device=dev, **kw)
        out[f"T{T}_ms"] = dict(eager=timed(lambda: r.eager(params[0], f)),
                               first_graph_call=timed(lambda: r(params[0], f)),
                               replay=timed(lambda: r(params[0], f)))
        del f, r
        torch.cuda.empty_cache()
    f = torch.randn((3, 1, 48, C, *GRID), generator=gen, device=dev)
    m = make_multitracer_rollout(cfg, [norm] * 3, **kw)
    sp = stack_params(params)
    first = timed(lambda: m(sp, f))
    out["multitracer"] = dict(first_call_ms=first,
                              replay_ms_step=[timed(lambda: m(sp, f)) / 48 for _ in range(5)])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
