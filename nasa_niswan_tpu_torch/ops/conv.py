"""Convolution and normalization primitives in NHWC (counterpart of
nasa_niswan_tpu/ops/conv.py).

Activations are NHWC and kernels HWIO, the JAX package's layouts; a
transposed conv's kernel is JAX's ``(kh, kw, out, in)``.  The output dtype
follows the input dtype, as in JAX: a bf16 input gives a bf16 product, and
a float32 bias then promotes the sum to float32.  The JAX package computes
none of these in a Pallas kernel, so each is PyTorch's own call (cuDNN on
the card) or plain tensor arithmetic.

Shapes follow XLA where torch would refuse: reflect padding repeats its
reflection when the pad reaches the map's size (``jnp.pad`` semantics), a
window larger than the padded map gives an empty map, and a transposed
conv of an empty map gives ``k - 1 - 2p`` rows of bias.  The pix2pix
generator meets all three at 128x128 input, where its bottleneck sees a
1x1 map.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    """Source rows of numpy's ``reflect`` padding of an n-long axis by p on
    each side: mirrored about the edge rows, without repeating them, and
    periodic with period 2 (n - 1) once p reaches n; a 1-long axis repeats."""
    i = torch.arange(-p, n + p, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)), mode="reflect")``
    of an NHWC tensor, for every map size."""
    x = x.index_select(1, _reflect_index(x.shape[1], ph, x.device))
    return x.index_select(2, _reflect_index(x.shape[2], pw, x.device))


def _no_product(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A zero that depends on ``x`` and ``kernel``: an empty product still
    gives both a (zero) gradient, as XLA's empty convolution does."""
    return x.flatten()[:0].sum() + kernel.flatten()[:0].sum()


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: Pair = 1,
    padding: Pair = 0,
    pad_mode: str = "zeros",
) -> torch.Tensor:
    """Cross-correlation of NHWC ``x`` with HWIO ``kernel``: ``padding``
    rows/cols on each side (zeros, or ``pad_mode="reflect"``), then a VALID
    window at ``stride``."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if kh == kw == 1 and (sh, sw) == (1, 1) and (ph, pw) == (0, 0):
        out = torch.matmul(x, kernel[0, 0])  # a 1x1 conv is a channel matmul
    else:
        if pad_mode == "reflect":
            x, ph, pw = reflect_pad(x, ph, pw), 0, 0
        elif pad_mode != "zeros":
            raise ValueError(f"pad_mode must be zeros|reflect, got {pad_mode!r}")
        H, W = x.shape[1] + 2 * ph, x.shape[2] + 2 * pw
        if H < kh or W < kw:  # the window overhangs the padded map
            out = x.new_zeros((x.shape[0], max(0, (H - kh) // sh + 1),
                               max(0, (W - kw) // sw + 1), kernel.shape[3]))
            out = out + _no_product(x, kernel)
        else:
            out = F.conv2d(
                x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=(sh, sw),
                padding=(ph, pw),
            ).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out


def conv2d_transpose(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: Pair = 2,
    padding: int = 0,
) -> torch.Tensor:
    """torch ``ConvTranspose2d`` of NHWC ``x``; ``kernel`` is (kh, kw, out,
    in), the HWIO kernel of the forward conv whose gradient this is (torch's
    weight is ``kernel.permute(3, 2, 0, 1)``).  Output size
    ``(in - 1) * stride - 2 * padding + k``."""
    sh, sw = _pair(stride)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if x.shape[1] == 0 or x.shape[2] == 0:
        # XLA pads the empty dilated map by k - 1 - p on each side
        out = x.new_zeros((x.shape[0], max(0, kh - 1 - 2 * padding),
                           max(0, kw - 1 - 2 * padding), kernel.shape[2]))
        out = out + _no_product(x, kernel)
    else:
        out = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=(sh, sw),
            padding=padding,
        ).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pool over the NHWC spatial dims (torch MaxPool2d(k, s), VALID)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def instance_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """InstanceNorm2d: per sample and channel over (H, W), biased variance,
    no running statistics."""
    var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm2d with torch semantics over NHWC ``x``.

    Returns ``(out, (new_running_mean, new_running_var))``.  Training
    normalizes by the batch statistics (biased variance) and moves the
    running statistics towards them with the *unbiased* variance; eval
    normalizes by the running statistics and passes them through.  The new
    statistics are computed outside autograd and the caller's tensors are
    left unchanged, as in the JAX package."""
    if training:
        var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
        with torch.no_grad():
            n = x.shape[0] * x.shape[1] * x.shape[2]
            unbiased = var * n / max(n - 1, 1)
            new_mean = (1 - momentum) * running_mean + momentum * mean
            new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    out = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return out, (new_mean, new_var)


def dropout2d(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], *,
    training: bool,
) -> torch.Tensor:
    """Channel-wise dropout (torch Dropout2d): whole channels of each sample
    are zeroed with probability ``rate`` (a (B, 1, 1, C) mask drawn from
    ``generator``, which lives on ``x``'s device); survivors are scaled by
    1 / (1 - rate).  Off unless ``training`` and a generator is given."""
    if not training or rate == 0.0 or generator is None:
        return x
    u = torch.rand((x.shape[0], 1, 1, x.shape[3]), generator=generator, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``: slope 1 at 0, as in the JAX package."""
    return torch.where(x >= 0, x, slope * x)
