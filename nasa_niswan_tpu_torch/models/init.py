"""Parameter initializers (counterpart of nasa_niswan_tpu/models/init.py).

The ConvLSTM keeps torch's default Conv2d init, U(+-1/sqrt(fan_in)) for
weight and bias.  Kernels are HWIO, the JAX package's layout, so weights
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
