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
from nasa_niswan_tpu_torch.parallel.halo import (
    cut_map,
    descend,
    halo_exchange_reflect,
    halo_exchange_zero,
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


def _down(x, p, mesh):
    """The reflect-padded 4x4 stride-2 conv: on the whole map (``mesh``
    None) or on this rank's tile, with a 1-pixel reflect halo (the tile's
    origin is even, so its outputs are the map's)."""
    if mesh is None:
        return conv2d(x, p["w"], p.get("b"), stride=2, padding=1, pad_mode="reflect")
    return conv2d(halo_exchange_reflect(x, 1, mesh), p["w"], p.get("b"), stride=2)


def _up(x, p, mesh):
    """The 4x4 stride-2 transposed conv (padding 1): on the whole map, or on
    the tile with a 1-pixel zero halo, whose outputs two pixels deep are
    cropped (padding 3)."""
    if mesh is None:
        return conv2d_transpose(x, p["w"], p.get("b"), stride=2, padding=1)
    return conv2d_transpose(halo_exchange_zero(x, 1, mesh), p["w"], p.get("b"), stride=2,
                            padding=3)


def _norm_act(x, p, act, group, generator=None, shard=(0, 1)):
    x = instance_norm(x, p["norm"]["scale"], p["norm"]["bias"], group=group)
    x = torch.relu(x) if act == "relu" else leaky_relu(x, 0.2)
    if generator is not None:
        x = dropout2d(x, 0.5, generator, training=True, shard=shard)
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
    shard: Tuple[int, int] = (0, 1),
    mesh=None,
) -> torch.Tensor:
    """x: (B, H, W, C) with H, W divisible by 256 (8 stride-2 stages; smaller
    maps follow XLA's shapes, ops/conv.py).  Dropout2d(0.5) runs on decoder
    blocks 1-3 only when ``training`` and a ``generator`` (on x's device)
    is given; ``shard=(r, n)`` marks x as part r of n of a global batch (a
    data-parallel rank's), whose masks are drawn for the whole batch
    (``ops.conv.dropout2d``).

    With a ``mesh`` (parallel/mesh.py) x is this rank's tile of its dp
    share (``shard`` is then the mesh's dp), and so is the output: the
    reflect-padded convs take a 1-pixel reflect halo, the transposed convs
    a 1-pixel zero halo, the InstanceNorms sum over the (lat, lon) plane.
    Levels follow the gather rule (``parallel/halo.descend``): from the first
    level whose tiles would not halve, the map is gathered and the deeper
    levels (at 256 x 256 the innermost, 1-4 pixels) run whole on every
    rank; the decoder cuts the map back to tiles at that level."""
    drop = generator if training else None
    if mesh is not None:
        shard = (mesh.index("dp"), mesh.dp)
    tiled = [mesh is not None]  # per level (map size 256 / 2^level): on tiles

    def on(level):
        return mesh if tiled[level] else None

    def group(level):
        return mesh.groups["latlon"] if tiled[level] else None

    def down(h, p):
        """The next level's conv from the deepest so far, gathering first
        where the rule says."""
        h, below = descend(h, tiled[-1], mesh)
        tiled.append(below)
        return _down(h, p, on(len(tiled) - 1))

    def up(h, p, level):
        """The transposed conv from ``level + 1`` to ``level``, cutting back
        to tiles where the rule gathered."""
        h = _up(h, p, on(level + 1))
        return cut_map(h, mesh) if tiled[level] and not tiled[level + 1] else h

    e0 = leaky_relu(down(x, params["initial"]), 0.2)  # level 1
    encs = [e0]
    h = e0
    for i in range(1, 7):  # enc i: level i + 1
        h = _norm_act(down(h, params[f"enc{i}"]), params[f"enc{i}"], "leaky",
                      group(i + 1))
        encs.append(h)
    bn = leaky_relu(down(h, params["bottleneck"]), 0.2)  # level 8
    h = _norm_act(up(bn, params["dec1"], 7), params["dec1"], "relu", group(7), drop, shard)
    for i in range(2, 8):  # dec i: level 8 - i
        h = torch.cat([h, encs[8 - i]], dim=-1)  # dec2 <- enc6 ... dec7 <- enc1
        h = _norm_act(up(h, params[f"dec{i}"], 8 - i), params[f"dec{i}"], "relu",
                      group(8 - i), drop if i <= 3 else None, shard)
    h = torch.cat([h, e0], dim=-1)
    return up(h, params["final"], 0)


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
