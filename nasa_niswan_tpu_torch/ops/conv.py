"""NHWC convolution (counterpart of ``conv2d`` in nasa_niswan_tpu/ops/conv.py,
zeros padding and the 1x1 case only).

Activations are NHWC and kernels HWIO, the JAX package's layouts.  The
output dtype follows the input dtype, as in JAX: a bf16 input gives a bf16
product, and a float32 bias then promotes the sum to float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: int = 0,
) -> torch.Tensor:
    """Stride-1 cross-correlation of NHWC ``x`` with HWIO ``kernel``, with
    ``padding`` rows/cols of zeros on each side."""
    if kernel.shape[0] == kernel.shape[1] == 1 and padding == 0:
        # a 1x1 conv is a channel matmul
        out = torch.matmul(x, kernel[0, 0])
    else:
        out = F.conv2d(
            x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=padding
        ).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out
