"""Operations and bytes of the ConvLSTM emulator's steps and kernel launches.

The model's work is the same whatever kernels implement it: per layer and
frame the gate conv over ``[x; h]``, 2 k^2 (Cin + h) 4h FLOPs a pixel of
the padded grid, plus the 1x1 head on the last layer's h.  A training step
counts three times its forward (the input gradient and the weight gradient
each as much again) and not the remat route's recompute of the gates.

A launch's least time is the larger of its FLOPs at the bf16 tensor-core
peak and its bytes at the HBM rate, each input byte read once and each
output byte written once (bf16 operands, f32 state and sums), as the port's
kernel table counts them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

PEAKS: Dict[str, float] = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def layers(config: dict) -> List[Tuple[int, int, int]]:
    """(k, Cin + h, h) of each cell: the channels of its [x; h] input."""
    out, cin = [], config["in_channels"]
    for hid, k in zip(config["hidden_channels"], config["kernel_sizes"]):
        out.append((k, cin + hid, hid))
        cin = hid
    return out


def pixels(config: dict) -> int:
    hp, wp = config["padded"]
    return hp * wp


def frame_flops(config: dict) -> float:
    """The gate convs of one frame, batch 1."""
    return float(sum(2 * k * k * cin * 4 * hid for k, cin, hid in layers(config))
                 * pixels(config))


def head_flops(config: dict) -> float:
    return 2.0 * config["hidden_channels"][-1] * pixels(config)


def serve_step_flops(config: dict, batch: int = 1) -> float:
    """One rollout step: every cell, and the head on every step."""
    return batch * (frame_flops(config) + head_flops(config))


def train_step_flops(config: dict, batch: int, seq: int) -> float:
    """One training step of ``batch`` windows of ``seq`` frames: three times
    the forward (cells on every frame, the head on each window's last)."""
    return 3.0 * batch * (seq * frame_flops(config) + head_flops(config))


def least_time_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def cell_fwd_work(px: int, cin: int, hid: int, k: int) -> Tuple[float, float]:
    """B1: xh (bf16), w (bf16) and b read, c read, h' and c' written (f32)."""
    kk = k * k * cin * 4 * hid
    return 2.0 * px * kk, px * cin * 2 + kk * 2 + 16 * hid + 3 * px * hid * 4


def cell_bwd_work(px: int, cin: int, hid: int, k: int) -> Tuple[float, float]:
    """B2: the gate recompute and dW, two products of the gate conv's size;
    xh, c, dh, dc, w, b read; dgates (bf16), dc_prev, dw and db written."""
    kk = k * k * cin * 4 * hid
    return (4.0 * px * kk,
            px * cin * 2 + 3 * px * hid * 4 + kk * 2 + px * 4 * hid * 2
            + px * hid * 4 + kk * 4 + 2 * 16 * hid)


def conv_same_work(px: int, cin: int, cout: int, k: int) -> Tuple[float, float]:
    """B3: x and w read (bf16), the f32 output written."""
    kk = k * k * cin * cout
    return 2.0 * px * kk, px * cin * 2 + kk * 2 + px * cout * 4


def serve_b1_bound_s(config: dict, batch: int = 1) -> float:
    """Least time of one rollout step's B1 launches, one per cell."""
    px = batch * pixels(config)
    return sum(least_time_s(*cell_fwd_work(px, cin, hid, k)) for k, cin, hid in layers(config))


def train_cell_kernels_bound_s(config: dict, batch: int, seq: int) -> float:
    """Least time of one remat training step's cell kernels: per cell and
    frame one B1, one B2 ((a) and dW) and one B3 (dxh from the gate
    cotangents)."""
    px = batch * pixels(config)
    per_frame = sum(
        least_time_s(*cell_fwd_work(px, cin, hid, k))
        + least_time_s(*cell_bwd_work(px, cin, hid, k))
        + least_time_s(*conv_same_work(px, 4 * hid, cin, k))
        for k, cin, hid in layers(config))
    return seq * per_frame
