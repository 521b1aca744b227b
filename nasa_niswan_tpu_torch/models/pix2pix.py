"""pix2pix Generator and PatchGAN Discriminator (counterpart of
nasa_niswan_tpu/models/pix2pix.py).

The Generator is a 7-deep stride-2 U-Net: reflect-padded 4x4 convs with
InstanceNorm and LeakyReLU(0.2) down, 4x4 transposed convs with
InstanceNorm and ReLU up, Dropout2d(0.5) on decoder blocks 1-3, and an
un-activated final transposed conv.  Its encoder and decoder blocks have
no conv bias.  The Discriminator is the PatchGAN over concat(x, y), its
last block at stride 1.

Weights are N(0, 0.02), conv biases (where present) keep torch's default
init, InstanceNorm's affine parameters start at (1, 0).  The trees carry
the JAX package's names.  Dropout draws from an explicit
``torch.Generator`` where JAX takes a key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nasa_niswan_tpu_torch.models.init import (
    normal_002_init,
    torch_conv_init,
    torch_conv_transpose_init,
)
from nasa_niswan_tpu_torch.ops.conv import (
    conv2d,
    conv2d_transpose,
    dropout2d,
    instance_norm,
    leaky_relu,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    in_channels: int = 5
    features: int = 64


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    in_channels: int = 1
    features: Tuple[int, ...] = (64, 128, 256, 512)


def _in_init(ch, device):
    return {"scale": torch.ones(ch, device=device), "bias": torch.zeros(ch, device=device)}


def _gblock_init(gen, in_ch, out_ch, encoder: bool, device):
    # no conv bias; a transposed kernel is (kh, kw, out, in)
    shape = (in_ch, out_ch) if encoder else (out_ch, in_ch)
    return {"w": normal_002_init(gen, 4, 4, *shape, device=device),
            "norm": _in_init(out_ch, device)}


def _biased_conv_init(gen, in_ch, out_ch, device, transpose=False):
    init = torch_conv_transpose_init if transpose else torch_conv_init
    _, b = init(gen, 4, 4, in_ch, out_ch, device=device)
    shape = (out_ch, in_ch) if transpose else (in_ch, out_ch)
    return {"w": normal_002_init(gen, 4, 4, *shape, device=device), "b": b}


def _gblock_apply(p, x, *, encoder, act, generator=None):
    if encoder:
        x = conv2d(x, p["w"], stride=2, padding=1, pad_mode="reflect")
    else:
        x = conv2d_transpose(x, p["w"], stride=2, padding=1)
    x = instance_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    x = torch.relu(x) if act == "relu" else leaky_relu(x, 0.2)
    if generator is not None:
        x = dropout2d(x, 0.5, generator, training=True)
    return x


def generator_init(generator: torch.Generator, config: GeneratorConfig, *, device=None
                   ) -> Params:
    f = config.features
    params: Params = {"initial": _biased_conv_init(generator, config.in_channels, f, device)}
    enc_chans = [(f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f)] + [(8 * f, 8 * f)] * 3
    for i, (ci, co) in enumerate(enc_chans, 1):
        params[f"enc{i}"] = _gblock_init(generator, ci, co, True, device)
    params["bottleneck"] = _biased_conv_init(generator, 8 * f, 8 * f, device)
    dec_chans = [(8 * f, 8 * f), (16 * f, 8 * f), (16 * f, 8 * f), (16 * f, 8 * f),
                 (16 * f, 4 * f), (8 * f, 2 * f), (4 * f, f)]
    for i, (ci, co) in enumerate(dec_chans, 1):
        params[f"dec{i}"] = _gblock_init(generator, ci, co, False, device)
    params["final"] = _biased_conv_init(generator, 2 * f, 1, device, transpose=True)
    return params


def generator_apply(
    params: Params,
    x: torch.Tensor,
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """x: (B, H, W, C) with H, W divisible by 256 (8 stride-2 stages; smaller
    maps follow XLA's shapes, ops/conv.py).  Dropout2d(0.5) runs on decoder
    blocks 1-3 only when ``training`` and a ``generator`` (on x's device)
    is given."""
    drop = generator if training else None
    e0 = leaky_relu(conv2d(x, params["initial"]["w"], params["initial"]["b"], stride=2,
                           padding=1, pad_mode="reflect"), 0.2)
    encs = [e0]
    h = e0
    for i in range(1, 7):
        h = _gblock_apply(params[f"enc{i}"], h, encoder=True, act="leaky")
        encs.append(h)
    bn = leaky_relu(conv2d(h, params["bottleneck"]["w"], params["bottleneck"]["b"],
                           stride=2, padding=1, pad_mode="reflect"), 0.2)
    h = _gblock_apply(params["dec1"], bn, encoder=False, act="relu", generator=drop)
    for i in range(2, 8):
        h = torch.cat([h, encs[8 - i]], dim=-1)  # dec2 <- enc6 ... dec7 <- enc1
        h = _gblock_apply(params[f"dec{i}"], h, encoder=False, act="relu",
                          generator=drop if i <= 3 else None)
    h = torch.cat([h, e0], dim=-1)
    return conv2d_transpose(h, params["final"]["w"], params["final"]["b"], stride=2,
                            padding=1)


def discriminator_init(generator: torch.Generator, config: DiscriminatorConfig, *,
                       device=None) -> Params:
    f = config.features
    params: Params = {
        "initial": _biased_conv_init(generator, config.in_channels * 2, f[0], device)}
    in_ch = f[0]
    for i, feat in enumerate(f[1:], 1):
        params[f"block{i}"] = _gblock_init(generator, in_ch, feat, True, device)
        in_ch = feat
    params["final"] = _biased_conv_init(generator, in_ch, 1, device)
    return params


def discriminator_apply(params: Params, x: torch.Tensor, y: torch.Tensor,
                        config: DiscriminatorConfig) -> torch.Tensor:
    """PatchGAN score map over concat(x, y)."""
    f = config.features
    h = leaky_relu(conv2d(torch.cat([x, y], dim=-1), params["initial"]["w"],
                          params["initial"]["b"], stride=2, padding=1,
                          pad_mode="reflect"), 0.2)
    for i, feat in enumerate(f[1:], 1):
        stride = 1 if feat == f[-1] else 2  # the last block at stride 1
        p = params[f"block{i}"]
        h = conv2d(h, p["w"], stride=stride, padding=1, pad_mode="reflect")
        h = leaky_relu(instance_norm(h, p["norm"]["scale"], p["norm"]["bias"]), 0.2)
    return conv2d(h, params["final"]["w"], params["final"]["b"], stride=1, padding=1,
                  pad_mode="reflect")
