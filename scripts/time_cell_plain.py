"""Time the fused cell kernel's plain mode (B1, no xg, no gate output) at
the three serving layer shapes on one NVIDIA GPU, to compare two versions
of ``csrc/convlstm_cell.cu`` within one machine session.

``--root`` names the checkout whose ``nasa_niswan_tpu_torch`` is imported
(default: the one holding this script); its kernels are built there at the
first launch.  bf16 operands, B = 1, 100x154, hidden 64/32/16, kernels
5/3/3, C = 62 inputs; random inputs from a seed.  Prints the card's name
and power limit, the build time, then per layer and in sum the mean time of
one launch, ``--reps`` times, two ways: "eager", CUDA events around
``--iters`` launches from Python (at B = 1 the small layers are bound by
the host's ~66 us per call), and "graph", CUDA events around the replay of
one CUDA graph holding ``--iters`` launches (device time only).

    python scripts/time_cell_plain.py [--root DIR] [--iters 200] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

SHAPES = (  # (B, H, W, Cin, hidden, k): serving layers 1-3
    (1, 100, 154, 62 + 64, 64, 5),
    (1, 100, 154, 64 + 32, 32, 3),
    (1, 100, 154, 32 + 16, 16, 3),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from nasa_niswan_tpu_torch.ops import _build
    from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"root {os.path.abspath(args.root)}: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for B, H, W, cin, hid, k in SHAPES:
        xh = torch.randn((B, H, W, cin), generator=gen, device=dev).bfloat16()
        c = torch.randn((B, H, W, hid), generator=gen, device=dev)
        w = (torch.randn((k, k, cin, 4 * hid), generator=gen, device=dev)
             / (k * k * cin) ** 0.5).bfloat16()
        b = 0.1 * torch.randn((4 * hid,), generator=gen, device=dev)
        cases.append(((xh, c, w, b), f"Cin={cin} hid={hid} k={k}"))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    with torch.no_grad():
        graphs = []
        for cell_args, _ in cases:
            for _ in range(10):
                fused_cell_forward(*cell_args)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(args.iters):
                    fused_cell_forward(*cell_args)
            graph.replay()
            graphs.append(graph)
        for rep in range(args.reps):
            total = {"eager": 0.0, "graph": 0.0}
            for (cell_args, tag), graph in zip(cases, graphs):
                ms = {
                    "eager": timed(lambda: [fused_cell_forward(*cell_args)
                                            for _ in range(args.iters)]),
                    "graph": timed(graph.replay),
                }
                for how, v in ms.items():
                    total[how] += v
                print(f"rep {rep} {tag}: eager {ms['eager']:.4f} ms, graph "
                      f"{ms['graph']:.4f} ms")
            print(f"rep {rep} three serving cells: eager {total['eager']:.4f} ms, "
                  f"graph {total['graph']:.4f} ms")


if __name__ == "__main__":
    main()
