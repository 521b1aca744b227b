#!/usr/bin/env python3
"""Summarize a torch.profiler trace of the port into roofline evidence, the
twin of scripts/trace_summary.py.

    python scripts/torch_profile_rollout.py --trace /tmp/tr --trace-steps 96
    python scripts/torch_trace_summary.py /tmp/tr --steps 96 --label full_scan \
        --out docs/profile_torch/rollout.json

Reads the Chrome trace that ``nasa_niswan_tpu_torch/utils/profiling.trace``
writes (``<dir>/trace.json``), or a trace file (``.json`` or ``.json.gz``).
Every GPU kernel event (``"cat": "kernel"``) counts; the device time is the
union of their intervals, so kernels that overlap on two streams count once.
Each kernel is put under the port's kernel it belongs to by its demangled
name, never by its position in the trace:

* B1 and B2's gate recompute (a) are one ``__global__``,
  ``cell_wgmma_kernel`` (``cell_fp32_kernel`` for f32 operands), templated
  on the epilogue: ``CellEpi`` is B1, ``BackwardEpi`` is B2 (a).  A cell
  kernel whose epilogue cannot be read from its name raises;
* ``pack_cell_weights_kernel`` packs a weight tensor for that mainloop;
* dW: ``dw_mma_kernel``, ``dw_partial_kernel`` (f32) and their helpers
  ``sum_rows_kernel``, ``sum_slots_kernel``, ``pad_channels_kernel``;
* B3: ``conv_same_mma_kernel``, ``conv_same_fp32_kernel`` (f32);
* ``conv_op``: every other convolution or matrix-product kernel (cuDNN,
  cuBLAS, whose nvjet kernels run the 1x1 head).

Beside the union: the span from the first kernel's start to the last one's
end, the share of it in which no kernel ran (``device_idle_frac``: the gaps
between the nodes of a replayed graph, or a host that does not keep up),
the largest such gap, and the copies' and memsets' time (``memcpy_ms``:
a graph's input copies).

The analytic FLOPs are the JAX script's ``conv_gflops_per_step``: the gate
convs of one B = 1 rollout step, 2 k^2 (Cin + h) 4h H W per layer, plus the
head.  The port has no column margins, so ``--width`` is 154 for every
label.  ``sustained_tflops`` divides them by the device time per step, and
``fraction_of_bf16_peak`` (the JAX script's TPU key ``mxu_fraction_of_peak``)
holds that against an H100's dense bf16 peak, 989 TFLOP/s.  The JAX
script's ``scan_ms`` (the TPU while loop) has no counterpart: the port's
time loop is host code.  B1's launches are also read by layer from the
kernel's template arguments (k, hidden / 8), each beside its least time on
the card at the config's layer shape.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import re
import subprocess
from typing import Dict, List, Optional, Sequence

# an H100 SXM's published peaks: dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_TFLOPS = 989.0
HBM_BYTES_S = 3.35e12
H = 100  # padded latitude rows

CONFIGS = {
    # (k, cin + h, 4h) per layer of the traced model
    "northstar": [(5, 62 + 64, 256), (3, 64 + 32, 128), (3, 32 + 16, 64)],
    # config #3 closed loop: 6ch surface (5 met + feedback)
    "closedloop6": [(5, 6 + 64, 256), (3, 64 + 32, 128), (3, 32 + 16, 64)],
    # the canonical training step's 8 input channels
    "train8": [(5, 8 + 64, 256), (3, 64 + 32, 128), (3, 32 + 16, 64)],
}

CELL_KERNELS = ("cell_wgmma_kernel", "cell_fp32_kernel")
DW_KERNELS = ("dw_mma_kernel", "dw_partial_kernel", "sum_rows_kernel",
              "sum_slots_kernel", "pad_channels_kernel")
B3_KERNELS = ("conv_same_mma_kernel", "conv_same_fp32_kernel")
PACK_KERNELS = ("pack_cell_weights_kernel",)
CONV_OP = re.compile(r"conv|gemm|xmma|cudnn|dgrad|wgrad|fprop|winograd|fft|nvjet", re.I)
B1_LAYER = re.compile(r"cell_wgmma_kernel<(\d+), ?(\d+)")
CLASSES = ("b1", "b2a", "cell_pack", "dw", "b3", "conv_op", "other")


def conv_gflops_per_step(width: int, config: str = "northstar") -> float:
    """Analytic gate-conv FLOPs of one rollout step (batch 1), NHWC
    (100, width) frames: per layer 2*k^2*(Cin+h)*4h*H*W."""
    layers = CONFIGS[config]
    fl = sum(2 * k * k * cin * cout * H * width for k, cin, cout in layers)
    fl += 2 * 16 * 1 * H * width  # 1x1 head tap
    return fl / 1e9


def train_gflops_per_step(config: str, batch: int, seq: int, width: int = 154):
    """(forward, forward + backward) GFLOPs of one training step: the gate
    convs of ``batch * seq`` frames, and three times that for the forward,
    the input gradient and the weight gradient (the remat route's gate
    recompute not counted)."""
    layers = CONFIGS[config]
    fwd = batch * seq * sum(2 * k * k * cin * cout * H * width for k, cin, cout in layers)
    return fwd / 1e9, 3 * fwd / 1e9


def cell_bound_ms(batch: int, width: int, cin: int, hid: int, k: int) -> float:
    """Least time of one B1 plain launch: the larger of its gate conv's
    FLOPs at the bf16 peak and its bytes (xh, w and b read, c read, h' and
    c' written, bf16 operands and f32 state) at the HBM rate."""
    px = batch * H * width
    flops = 2.0 * px * k * k * cin * 4 * hid
    nbytes = px * cin * 2 + k * k * cin * 4 * hid * 2 + 16 * hid + 3 * px * hid * 4
    return 1e3 * max(flops / (PEAK_BF16_TFLOPS * 1e12), nbytes / HBM_BYTES_S)


def kernel_class(name: str) -> str:
    """The port's kernel a GPU kernel of the trace belongs to (CLASSES)."""
    if any(k in name for k in CELL_KERNELS):
        if "BackwardEpi" in name:
            return "b2a"
        if "CellEpi" in name:
            return "b1"
        raise ValueError(f"a cell kernel whose epilogue is not in its name: {name}")
    if any(k in name for k in DW_KERNELS):
        return "dw"
    if any(k in name for k in B3_KERNELS):
        return "b3"
    if any(k in name for k in PACK_KERNELS):
        return "cell_pack"
    if CONV_OP.search(name):
        return "conv_op"
    return "other"


def trace_path(path: str) -> str:
    """The trace file: ``path`` itself, or ``path/trace.json`` for the
    directory ``utils/profiling.trace`` writes."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    if not os.path.isfile(path):
        raise SystemExit(f"no trace at {path}")
    return path


def load_trace(path: str) -> dict:
    path = trace_path(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def union_us(intervals: Sequence[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events: List[dict], *, steps: int, label: str, config: str = "northstar",
              width: int = 154, batch: int = 1, gflops_per_step: Optional[float] = None,
              trace: Optional[str] = None, card: Optional[str] = None) -> Dict:
    """The summary of a trace's kernel events over ``steps`` steps.
    ``gflops_per_step`` replaces the serving count (a training step's)."""
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    by_name = collections.Counter()
    by_class = collections.Counter()
    launches = collections.Counter()
    b1_layers = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        name, dur = e["name"], float(e.get("dur", 0))
        cls = kernel_class(name)
        by_name[name] += dur
        by_class[cls] += dur
        launches[cls] += 1
        m = B1_LAYER.search(name) if cls == "b1" else None
        if m:
            row = b1_layers[int(m.group(1)), 8 * int(m.group(2))]
            row[0] += 1
            row[1] += dur
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in kernels]
    total_us = union_us(spans)
    span_us = max(e for _, e in spans) - min(s for s, _ in spans) if spans else 0.0
    ends = sorted(spans)
    gap_us, reach = 0.0, None
    for s, e in ends:
        if reach is not None and s > reach:
            gap_us = max(gap_us, s - reach)
        reach = e if reach is None else max(reach, e)
    copies_us = sum(float(e.get("dur", 0)) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    dev_ms_step = total_us / 1e3 / steps
    gflops = conv_gflops_per_step(width, config) if gflops_per_step is None \
        else gflops_per_step
    tflops = gflops / dev_ms_step if dev_ms_step > 0 else None  # GFLOP/ms == TFLOP/s
    layer_cin = {(k, cout // 4): cin for k, cin, cout in CONFIGS[config]}
    layers = []
    for (k, hid), (n, us) in sorted(b1_layers.items(), key=lambda kv: -kv[0][1]):
        row = {"k": k, "hid": hid, "launches": n, "ms_per_launch": us / 1e3 / n}
        if (k, hid) in layer_cin:
            row["bound_ms"] = cell_bound_ms(batch, width, layer_cin[k, hid], hid, k)
            row["fraction_of_bound"] = row["bound_ms"] / row["ms_per_launch"]
        layers.append(row)
    top: Dict[str, float] = {}
    for name, us in by_name.most_common(12):
        top[name[:80]] = top.get(name[:80], 0.0) + us / 1e3
    ms = {cls: by_class[cls] / 1e3 for cls in CLASSES}
    return {
        "label": label,
        "config": config,
        "steps": steps,
        "width": width,
        "batch": batch,
        "trace": trace,
        "card": card,
        "kernel_events": len(kernels),
        "device_total_ms": total_us / 1e3,
        "device_ms_per_step": dev_ms_step,
        "device_span_ms": span_us / 1e3,
        "device_idle_frac": 1 - total_us / span_us if span_us > 0 else None,
        "largest_gap_ms": gap_us / 1e3,
        "memcpy_ms": copies_us / 1e3,
        "cell_kernel_ms": ms["b1"] + ms["b2a"] + ms["cell_pack"],
        "b1_ms": ms["b1"],
        "b2a_ms": ms["b2a"],
        "cell_pack_ms": ms["cell_pack"],
        "dw_ms": ms["dw"],
        "b3_ms": ms["b3"],
        "conv_op_ms": ms["conv_op"],
        "other_ms": ms["other"],
        "launches": {cls: launches[cls] for cls in CLASSES},
        "b1_layers": layers,
        "analytic_gflops_per_step": gflops,
        "sustained_tflops": tflops,
        "fraction_of_bf16_peak": None if tflops is None else tflops / PEAK_BF16_TFLOPS,
        "top_ops_ms": top,
    }


def summarize_file(path: str, **kw) -> Dict:
    """``summarize`` of the trace at ``path`` (a file or the directory
    ``utils/profiling.trace`` wrote); the card defaults to the name the
    trace records."""
    data = load_trace(path)
    props = data.get("deviceProperties") or [{}]
    kw.setdefault("card", props[0].get("name"))
    return summarize(data["traceEvents"], trace=os.path.relpath(trace_path(path)), **kw)


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them for a CUDA
    ``device``; "cpu" for the CPU."""
    if str(device).startswith("cuda"):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    return "cpu"


def write_json(obj, path: Optional[str]) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--width", type=int, default=154,
                    help="conv width for FLOP accounting (the port has no column margins)")
    ap.add_argument("--config", default="northstar", choices=sorted(CONFIGS),
                    help="traced model for analytic FLOP accounting")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch of the traced cells (B1's per-layer bound)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    summary = summarize_file(args.trace_dir, steps=args.steps, label=args.label,
                             config=args.config, width=args.width, batch=args.batch)
    print(json.dumps(summary, indent=1))
    write_json(summary, args.out)
    return summary


if __name__ == "__main__":
    main()
