"""UNet (counterpart of nasa_niswan_tpu/models/unet.py).

Four encoder stages of conv_block = 2 x (Conv3x3 + BatchNorm + ReLU), each
followed by a 2x2 max pool; a bottleneck block of twice the last width;
four decoder stages of a k=2, s=2 transposed conv, the skip concatenated
after the upsampled map (``(up, skip)``), and a block; a 1x1 head.
Weights are N(0, 0.02), biases keep torch's default init.

The parameter and state trees carry the JAX package's names, so both
flatten in the same order and a checkpoint of either package loads in the
other.  BatchNorm's running statistics are the model state:
``unet_apply`` returns ``(out, new_state)`` and leaves ``state`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from nasa_niswan_tpu_torch.models.init import (
    normal_002_init,
    torch_conv_init,
    torch_conv_transpose_init,
)
from nasa_niswan_tpu_torch.ops.conv import batch_norm, conv2d, conv2d_transpose, max_pool2d

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 5
    out_channels: int = 1
    features: Tuple[int, ...] = (64, 128, 256, 512)


def _conv_init(gen, kh, in_ch, out_ch, device):
    _, b = torch_conv_init(gen, kh, kh, in_ch, out_ch, device=device)
    return {"w": normal_002_init(gen, kh, kh, in_ch, out_ch, device=device), "b": b}


def _bn_init(ch, device):
    params = {"scale": torch.ones(ch, device=device), "bias": torch.zeros(ch, device=device)}
    state = {"mean": torch.zeros(ch, device=device), "var": torch.ones(ch, device=device)}
    return params, state


def _block_init(gen, in_ch, out_ch, device):
    bn1_p, bn1_s = _bn_init(out_ch, device)
    bn2_p, bn2_s = _bn_init(out_ch, device)
    params = {
        "conv1": _conv_init(gen, 3, in_ch, out_ch, device),
        "bn1": bn1_p,
        "conv2": _conv_init(gen, 3, out_ch, out_ch, device),
        "bn2": bn2_p,
    }
    return params, {"bn1": bn1_s, "bn2": bn2_s}


def _block_apply(p, s, x, training):
    new = {}
    for i in (1, 2):
        conv, bn = p[f"conv{i}"], f"bn{i}"
        x = conv2d(x, conv["w"], conv["b"], padding=1)
        x, (mean, var) = batch_norm(x, p[bn]["scale"], p[bn]["bias"], s[bn]["mean"],
                                    s[bn]["var"], training=training)
        x = torch.relu(x)
        new[bn] = {"mean": mean, "var": var}
    return x, new


def unet_init(generator: torch.Generator, config: UNetConfig, *, device=None
              ) -> Tuple[Params, Params]:
    """Returns ``(params, state)``, the state holding BatchNorm's running
    statistics (mean 0, var 1).  Draws from ``generator`` on its device,
    then moves to ``device``."""
    f = config.features
    params: Params = {}
    state: Params = {}
    chans = [(config.in_channels, f[0]), (f[0], f[1]), (f[1], f[2]), (f[2], f[3])]
    for i, (ci, co) in enumerate(chans, 1):
        params[f"enc{i}"], state[f"enc{i}"] = _block_init(generator, ci, co, device)
    params["bottleneck"], state["bottleneck"] = _block_init(generator, f[3], 2 * f[3], device)
    up_chans = [(2 * f[3], f[3]), (f[3], f[2]), (f[2], f[1]), (f[1], f[0])]
    for i, (ci, co) in enumerate(up_chans):
        name = f"dec{4 - i}"
        _, up_b = torch_conv_transpose_init(generator, 2, 2, ci, co, device=device)
        # transposed-conv kernel (kh, kw, out, in): ops.conv.conv2d_transpose
        params[name] = {"up": {"w": normal_002_init(generator, 2, 2, co, ci, device=device),
                               "b": up_b}}
        params[name]["block"], state[name] = _block_init(generator, ci, co, device)
    params["head"] = _conv_init(generator, 1, f[0], config.out_channels, device)
    return params, state


def unet_apply(params: Params, state: Params, x: torch.Tensor, *, training: bool = False
               ) -> Tuple[torch.Tensor, Params]:
    """x: (B, H, W, C) NHWC, H and W divisible by 16.  Returns (out (B, H, W,
    out_channels), new_state)."""
    new_state: Params = {}
    skips = []
    h = x
    for i in range(1, 5):
        h, new_state[f"enc{i}"] = _block_apply(params[f"enc{i}"], state[f"enc{i}"], h,
                                               training)
        skips.append(h)
        h = max_pool2d(h)
    h, new_state["bottleneck"] = _block_apply(params["bottleneck"], state["bottleneck"],
                                              h, training)
    for i, skip in zip(range(4, 0, -1), reversed(skips)):
        name = f"dec{i}"
        up = params[name]["up"]
        h = conv2d_transpose(h, up["w"], up["b"], stride=2, padding=0)
        h = torch.cat([h, skip], dim=-1)  # (up, skip) order
        h, new_state[name] = _block_apply(params[name]["block"], state[name], h, training)
    return conv2d(h, params["head"]["w"], params["head"]["b"]), new_state
