"""Geophysical padding for global lat-lon fields, on torch tensors
(counterpart of nasa_niswan_tpu/core/padding.py, bit-exact with it).

The globe wraps in longitude and mirrors at the poles:

  1. cyclic padding along longitude   -- wrap-around copy of the far side;
  2. reflective padding along latitude -- mirror about the pole row,
     *excluding* the boundary row itself.

Layout: the last two axes are (lat, lon); leading axes are untouched.
``quirk_channel_flip=True`` reproduces the upstream 4-D bug that flips axis
1 (the channel axis of a (T, C, H, W) array) instead of latitude.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _split_pad(total: int, current: int) -> Tuple[int, int]:
    """Symmetric split of (total - current), the larger half second."""
    first = (total - current) // 2
    return first, total - current - first


def pad_cyclic_lon(x: torch.Tensor, target_lon: int) -> torch.Tensor:
    """Cyclically extend the longitude (last) axis to ``target_lon``
    columns: the left pad is the last ``pad_left`` columns, the right pad
    the first ``pad_right``."""
    w = x.shape[-1]
    pad_left, pad_right = _split_pad(target_lon, w)
    if pad_left < 0 or pad_right < 0:
        raise ValueError(f"target_lon={target_lon} smaller than lon size {w}")
    if pad_left > w or pad_right > w:
        raise ValueError(
            f"requested lon padding ({pad_left},{pad_right}) exceeds lon size {w}"
        )
    parts = []
    if pad_left:
        parts.append(x[..., w - pad_left :])
    parts.append(x)
    if pad_right:
        parts.append(x[..., :pad_right])
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def pad_reflect_lat(
    x: torch.Tensor,
    target_lat: int,
    *,
    quirk_channel_flip: bool = False,
) -> torch.Tensor:
    """Reflect the latitude (second-to-last) axis to ``target_lat`` rows.
    With pad p the rows added above row 0 are rows p..1 and the rows added
    below row H-1 are rows H-2..H-1-p."""
    h = x.shape[-2]
    pad_top, pad_bottom = _split_pad(target_lat, h)
    if pad_top < 0 or pad_bottom < 0:
        raise ValueError(f"target_lat={target_lat} smaller than lat size {h}")
    if pad_top >= h or pad_bottom >= h:
        raise ValueError(
            f"requested lat padding ({pad_top},{pad_bottom}) exceeds lat size {h}"
        )
    flip_dim = 1 if quirk_channel_flip and x.dim() >= 4 else x.dim() - 2

    parts = []
    if pad_top:
        parts.append(torch.flip(x[..., 1 : 1 + pad_top, :], dims=(flip_dim,)))
    parts.append(x)
    if pad_bottom:
        parts.append(
            torch.flip(x[..., h - 1 - pad_bottom : h - 1, :], dims=(flip_dim,))
        )
    return torch.cat(parts, dim=-2) if len(parts) > 1 else x


def pad_geo(
    x: torch.Tensor,
    target_shape: Tuple[int, int],
    *,
    quirk_channel_flip: bool = False,
) -> torch.Tensor:
    """Cyclic longitude pad, then reflective latitude pad, to
    ``target_shape`` = (padded_lat, padded_lon)."""
    x = pad_cyclic_lon(x, target_shape[1])
    return pad_reflect_lat(
        x, target_shape[0], quirk_channel_flip=quirk_channel_flip
    )


def crop_to_grid(
    x: torch.Tensor,
    grid_shape: Tuple[int, int],
    offsets: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Crop the last two axes back to the physical grid; the default
    offsets (padded - grid) // 2 invert ``pad_geo``."""
    h, w = grid_shape
    if offsets is None:
        offsets = ((x.shape[-2] - h) // 2, (x.shape[-1] - w) // 2)
    oh, ow = offsets
    return x[..., oh : oh + h, ow : ow + w]
