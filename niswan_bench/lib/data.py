"""Seeded inputs, made on the device in a few large calls.

Every run draws its weights, normalizer statistics, static fields, forcings
and targets from one ``torch.Generator`` seeded by ``--seed``, in a fixed
order, so the same seed gives the same inputs and every seed the same sizes.
The fields are not white noise alone: each channel has a spatial pattern
whose amplitude changes from frame to frame, so windows and batches differ
from each other as real days do, and normalizing by the statistics is not
the identity.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

BLOCK = 512  # frames drawn per call into a slab


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def convlstm_params(gen: torch.Generator, config: dict, device, *, trainable: bool = False):
    """The emulator's parameter tree, f32: per cell ``w_x`` (k, k, Cin, 4h),
    ``w_h`` (k, k, h, 4h), ``b`` (4h,), and the 1x1 head ``w``, ``b``; each
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in the combined kernel's, as
    torch's Conv2d draws.  One draw for the whole tree."""
    shapes = []
    cin = config["in_channels"]
    for hid, k in zip(config["hidden_channels"], config["kernel_sizes"]):
        bound = 1.0 / (k * k * (cin + hid)) ** 0.5
        shapes += [((k, k, cin, 4 * hid), bound), ((k, k, hid, 4 * hid), bound),
                   ((4 * hid,), bound)]
        cin = hid
    bound = 1.0 / cin ** 0.5
    shapes += [((1, 1, cin, 1), bound), ((1,), bound)]
    sizes = [int(np.prod(s)) for s, _ in shapes]
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    leaves = [(part.view(shape) * bound).contiguous().requires_grad_(trainable)
              for part, (shape, bound) in zip(flat.split(sizes), shapes)]
    cells = [dict(zip(("w_x", "w_h", "b"), leaves[3 * i: 3 * i + 3]))
             for i in range(len(config["hidden_channels"]))]
    return {"cells": cells, "head": {"w": leaves[-2], "b": leaves[-1]}}


def normalizer_stats(gen: torch.Generator, channels: int) -> Dict[str, object]:
    """Per-channel means and standard deviations of the forcings and the
    target's, as the raw fields are drawn with them."""
    u = torch.rand(2 * channels + 2, generator=gen, device=gen.device).cpu().numpy()
    return {
        "x_mean": (10.0 * u[:channels] - 5.0).astype(np.float32),
        "x_std": (0.5 + 2.5 * u[channels:2 * channels]).astype(np.float32),
        "y_mean": float(1.0 + u[-2]),
        "y_std": float(0.2 + 0.3 * u[-1]),
    }


def static_fields(gen: torch.Generator, n: int, grid) -> np.ndarray:
    """``n`` static maps (n, H, W), f32 on the host (the port z-scores them)."""
    x = torch.randn((n, *grid), generator=gen, device=gen.device)
    return (3.0 * x + 7.0).cpu().numpy()


def _field(gen: torch.Generator, n: int, frame_shape, stats: Dict[str, object]):
    """A slab's pattern P (C, H, W), amplitudes a (n, C) and statistics."""
    dev = gen.device
    c = frame_shape[0]
    pattern = torch.randn(tuple(frame_shape), generator=gen, device=dev)
    amp = torch.randn((n, c), generator=gen, device=dev)
    mean = torch.as_tensor(stats["x_mean"], device=dev).view(1, c, 1, 1)
    std = torch.as_tensor(stats["x_std"], device=dev).view(1, c, 1, 1)
    return pattern, amp, mean, std


def _fill(gen: torch.Generator, blk: torch.Tensor, field, a: int) -> None:
    """Frames a.. of a slab into ``blk``: mean + std * (0.8 a_t,c P_c + 0.6 noise)."""
    pattern, amp, mean, std = field
    blk.normal_(generator=gen).mul_(0.6)
    blk.add_(0.8 * amp[a:a + len(blk), :, None, None] * pattern)
    blk.mul_(std).add_(mean)


def frames(gen: torch.Generator, shape, stats: Dict[str, object]) -> torch.Tensor:
    """Raw forcings of ``shape`` (..., C, H, W) on the generator's device."""
    out = torch.empty(shape, device=gen.device)
    flat = out.view(-1, *shape[-3:])
    field = _field(gen, len(flat), shape[-3:], stats)
    for a in range(0, len(flat), BLOCK):
        _fill(gen, flat[a:a + BLOCK], field, a)
    return out


def targets(gen: torch.Generator, n: int, grid, stats: Dict[str, object]) -> torch.Tensor:
    """Raw targets (n, H, W): y_mean + y_std * (b_t Q + 0.5 noise)."""
    dev = gen.device
    pattern = torch.randn(tuple(grid), generator=gen, device=dev)
    amp = torch.randn((n, 1, 1), generator=gen, device=dev)
    y = torch.randn((n, *grid), generator=gen, device=dev).mul_(0.5).add_(amp * pattern)
    return y.mul_(stats["y_std"]).add_(stats["y_mean"])


def tree_leaves(params) -> List[torch.Tensor]:
    return [t for cell in params["cells"] for t in cell.values()] + list(params["head"].values())
