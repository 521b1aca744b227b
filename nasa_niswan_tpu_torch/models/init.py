"""Parameter initializers (counterpart of nasa_niswan_tpu/models/init.py).

The ConvLSTM keeps torch's default Conv2d init, U(+-1/sqrt(fan_in)) for
weight and bias; UNet and pix2pix weights are N(0, 0.02) and their biases
keep the default.  Kernels are HWIO, the JAX package's layout, so weights
cross the bridge without a transpose.  Randomness comes from an explicit
``torch.Generator``; a given seed draws other numbers than ``jax.random``
does, so parity tests pass weights across instead of re-drawing them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def torch_conv_init(
    generator: torch.Generator,
    kh: int,
    kw: int,
    in_ch: int,
    out_ch: int,
    *,
    bias: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """torch Conv2d default init, fan_in = in_ch * kh * kw; kernel HWIO.
    Draws on the generator's device, then moves to ``device``."""
    bound = 1.0 / math.sqrt(in_ch * kh * kw)
    gen_device = generator.device
    kernel = torch.empty((kh, kw, in_ch, out_ch), dtype=dtype, device=gen_device)
    kernel.uniform_(-bound, bound, generator=generator)
    b = None
    if bias:
        b = torch.empty((out_ch,), dtype=dtype, device=gen_device)
        b.uniform_(-bound, bound, generator=generator)
        b = b.to(device)
    return kernel.to(device), b


def torch_conv_transpose_init(
    generator: torch.Generator,
    kh: int,
    kw: int,
    in_ch: int,
    out_ch: int,
    *,
    bias: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """torch ConvTranspose2d default init: torch's weight dim 1 is out_ch, so
    fan_in = out_ch * kh * kw.  Kernel (kh, kw, out_ch, in_ch), as
    ``ops.conv.conv2d_transpose`` takes it."""
    bound = 1.0 / math.sqrt(out_ch * kh * kw)
    kernel = torch.empty((kh, kw, out_ch, in_ch), dtype=dtype, device=generator.device)
    kernel.uniform_(-bound, bound, generator=generator)
    b = None
    if bias:
        b = torch.empty((out_ch,), dtype=dtype, device=generator.device)
        b.uniform_(-bound, bound, generator=generator)
        b = b.to(device)
    return kernel.to(device), b


def normal_002_init(
    generator: torch.Generator, kh: int, kw: int, in_ch: int, out_ch: int, *,
    dtype: torch.dtype = torch.float32, device=None,
) -> torch.Tensor:
    """N(0, 0.02) weight init, the UNet / pix2pix regime; (kh, kw, in_ch,
    out_ch)."""
    w = torch.randn((kh, kw, in_ch, out_ch), generator=generator, dtype=dtype,
                    device=generator.device)
    return (0.02 * w).to(device)
