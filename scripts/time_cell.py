"""Time the fused cell kernels on one NVIDIA GPU: B1 in its three modes and
B2's gate recompute (part (a)) at the serving and training shapes, to
compare two versions of ``csrc/cell_mainloop.cuh`` within one machine
session.

``--root`` names the checkout whose ``nasa_niswan_tpu_torch`` is imported
(default: the one holding this script); its kernels are built there at the
first launch.  bf16 operands, 100x154, C = 62 serving inputs, hidden
64/32/16, kernels 5/3/3; random inputs from a seed.  Each case is timed as
device time: CUDA events around the replay of one CUDA graph holding
``--iters`` launches (at B = 1 the host's per-call cost would otherwise set
the pace), ``--reps`` times.  B2 (a) is timed two ways: the whole B2 call
minus B2's dW alone at the same shape (any version), and, where the
package has it, ``convgrad.cell_bwd_recompute`` directly.  Prints the card's
name and power limit, the build time, one line per case and rep, then one
JSON line with the means over the reps and each case's least time
(max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), every operand once).

    python scripts/time_cell.py [--root DIR] [--iters 20] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PEAK_BF16, HBM_BYTES_S = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
# (name, mode, (B, H, W, Cin, hid, k)); mode: plain, gates, xg, gates+xg,
# b2 (the whole backward), dw (B2's dW alone), b2a (part (a) alone)
SERVE = [(1, 100, 154, 126, 64, 5), (1, 100, 154, 96, 32, 3), (1, 100, 154, 48, 16, 3)]
TRAIN = [(8, 100, 154, 72, 64, 5), (8, 100, 154, 96, 32, 3), (8, 100, 154, 48, 16, 3)]
CASES = (
    [(f"serve L{i + 1} plain", "plain", s) for i, s in enumerate(SERVE)]
    + [("serve Cin 128 plain", "plain", (1, 100, 154, 128, 64, 5)),
       ("serve L1 xg (hoisted)", "xg", (1, 100, 154, 64, 64, 5))]
    + [(f"train L{i + 1} plain", "plain", s) for i, s in enumerate(TRAIN)]
    + [(f"train L{i + 1} emit_gates", "gates", s) for i, s in enumerate(TRAIN)]
    + [("train L1 xg+emit_gates (hoisted)", "gates+xg", (8, 100, 154, 64, 64, 5)),
       ("config3 L1 emit_gates", "gates", (8, 100, 154, 70, 64, 5))]
    + [(f"train L{i + 1} B2", "b2", s) for i, s in enumerate(TRAIN)]
    + [(f"train L{i + 1} B2 dW", "dw", s) for i, s in enumerate(TRAIN)]
    + [(f"train L{i + 1} B2 (a)", "b2a", s) for i, s in enumerate(TRAIN)]
)


def bound_ms(mode, B, H, W, cin, hid, k):
    """The least time of one launch: the FLOPs of its convs (B2: the gate
    recompute and dW), every input read once and every output written once."""
    px, kk = B * H * W, k * k * cin * 4 * hid
    gates = px * 4 * hid * 2  # one (B,H,W,4*hid) bf16 tensor
    if mode == "dw":  # in xh, dgates; out dw f32
        flops, nbytes = 2.0 * px * kk, px * cin * 2 + gates + kk * 4
    elif mode in ("b2", "b2a"):  # in xh, w, b, c, dh, dc; out dgates, dc_prev, db (+ dw)
        flops = 2.0 * px * kk * (2 if mode == "b2" else 1)
        nbytes = px * cin * 2 + kk * 2 + 32 * hid + 4 * px * hid * 4 + gates
        nbytes += kk * 4 if mode == "b2" else 0
    else:  # in xh, w, b, c (+ xg); out h', c' (+ gates)
        flops = 2.0 * px * kk
        nbytes = px * cin * 2 + kk * 2 + 16 * hid + 3 * px * hid * 4
        nbytes += gates * (("gates" in mode) + ("xg" in mode))
    return 1e3 * max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cases", default="", help="comma-separated names to time (default: all)")
    args = ap.parse_args()
    only = [c for c in args.cases.split(",") if c]
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from nasa_niswan_tpu_torch.ops import _build, convgrad
    from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward, fused_cell_gates

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"root {os.path.abspath(args.root)}: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    recompute = getattr(convgrad, "cell_bwd_recompute", None)

    def make(mode, B, H, W, cin, hid, k):
        xh = rand(B, H, W, cin).bfloat16()
        c, dh, dc = rand(B, H, W, hid), rand(B, H, W, hid), rand(B, H, W, hid)
        w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
        b = 0.1 * rand(4 * hid)
        xg = rand(B, H, W, 4 * hid).bfloat16() if "xg" in mode else None
        if mode in ("plain", "xg"):
            return lambda: fused_cell_forward(xh, c, w, b, xg)
        if mode.startswith("gates"):
            return lambda: fused_cell_gates(xh, c, w, b, xg)
        if mode == "b2":
            return lambda: convgrad.fused_cell_bwd(xh, c, dh, dc, w, b)
        if mode == "dw":
            g = rand(B, H, W, 4 * hid).bfloat16()
            return lambda: convgrad.conv_dw(xh, g, k)
        if recompute is None:
            return None
        return lambda: recompute(xh, c, dh, dc, w, b)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    results = {}
    with torch.no_grad():
        for name, mode, shape in CASES:
            if only and name not in only:
                continue
            fn = make(mode, *shape)
            if fn is None:
                continue
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                for _ in range(args.iters):
                    fn()
            graph.replay()
            torch.cuda.synchronize()
            times = []
            for rep in range(args.reps):
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / args.iters)
                print(f"rep {rep} {name} {shape}: {times[-1]:.4f} ms")
            results[name] = {"shape": list(shape), "ms": sum(times) / len(times),
                             "bound_ms": bound_ms(mode, *shape)}
            del graph, fn
            torch.cuda.empty_cache()
    for i in range(3):  # B2 (a) as the whole call minus its dW alone
        if f"train L{i + 1} B2" not in results or f"train L{i + 1} B2 dW" not in results:
            continue
        b2, dw = results[f"train L{i + 1} B2"], results[f"train L{i + 1} B2 dW"]
        results[f"train L{i + 1} B2 - dW"] = {
            "shape": b2["shape"], "ms": b2["ms"] - dw["ms"],
            "bound_ms": bound_ms("b2a", *b2["shape"])}
    sums = {
        "serve three cells plain": [f"serve L{i} plain" for i in (1, 2, 3)],
        "train three layers emit_gates": [f"train L{i} emit_gates" for i in (1, 2, 3)],
        "train three layers plain": [f"train L{i} plain" for i in (1, 2, 3)],
    }
    for name, parts in sums.items():
        if not all(p in results for p in parts):
            continue
        results[name] = {"ms": sum(results[p]["ms"] for p in parts),
                         "bound_ms": sum(results[p]["bound_ms"] for p in parts)}
    for name, r in results.items():
        print(f"{name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms)")
    print(json.dumps({"root": os.path.abspath(args.root), "device": smi, "cases": results}))


if __name__ == "__main__":
    main()
