"""Plain PyTorch reference of the ConvLSTM emulator, f32 with TF32 off.

Written from the model's description, not from the port: frames are
normalized per channel, the z-scored static maps appended, then padded to
the model's grid (cyclic in longitude, mirrored at the poles without the
boundary row); each cell convolves ``[x; h]`` with its combined kernel
``[w_x; w_h]`` (SAME, HWIO weights) plus its bias into the gates i, f, g, o,
then c' = c sigmoid(f) + sigmoid(i) tanh(g) and h' = sigmoid(o) tanh(c');
a 1x1 head reads the last cell's h, is cropped back to the grid and, when
serving, unnormalized.  Training takes MSE + L1 of the window's last
prediction against the normalized target and steps Adam.  Activations are
NCHW here; carries cross to and from the port's NHWC layout with
``to_nchw`` / ``to_nhwc``.

``precision`` is "f32" (the reference) or "fp8": every conv operand (the
cell inputs, the kernels, the head's input and kernel) rounded to
float8_e4m3 and, in training, the gate cotangents the backward convs read
rounded to float8_e5m2 (fp8 training's formats), one scale per tensor: the
control, the step below the bf16 operands and gate cotangents that the
configurations state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # format: largest value


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convs inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor, fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to an fp8 format with one scale for the tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8[fmt]
    return (x.detach() / scale).to(fmt).float() * scale


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision``; the gradient passes straight through."""
    if precision == "f32":
        return x
    return x + (fp8(x) - x.detach())


class _RoundedCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to
    float8_e5m2, the format fp8 training gives gradients."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g, torch.float8_e5m2)


def round_cotangent(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x``, whose gradient is rounded to ``precision`` on the way back (the
    gate cotangents that the weight and input gradients read)."""
    return x if precision == "f32" else _RoundedCotangent.apply(x)


def pad_grid(x: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
    """(..., H, W) -> (..., Hp, Wp): longitude wraps (left pad from the far
    side, the larger half on the right), latitude mirrors about the edge row
    (rows p..1 above row 0, rows H-2..H-1-p below row H-1)."""
    h, w = x.shape[-2:]
    left = (padded[1] - w) // 2
    right = padded[1] - w - left
    x = torch.cat([x[..., w - left:], x, x[..., :right]], dim=-1)
    top = (padded[0] - h) // 2
    bottom = padded[0] - h - top
    above = x[..., 1:1 + top, :].flip(-2)
    below = x[..., h - 1 - bottom:h - 1, :].flip(-2)
    return torch.cat([above, x, below], dim=-2)


def crop_grid(x: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    oh = (x.shape[-2] - grid[0]) // 2
    ow = (x.shape[-1] - grid[1]) // 2
    return x[..., oh:oh + grid[0], ow:ow + grid[1]]


def zscore_maps(static: np.ndarray) -> np.ndarray:
    """Each static map to zero mean and unit deviation over the grid."""
    s = np.asarray(static, dtype=np.float64)
    m = s.mean(axis=(1, 2), keepdims=True)
    d = s.std(axis=(1, 2), keepdims=True)
    return ((s - m) / d).astype(np.float32)


def to_nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).float().contiguous()


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def params_tree(leaves: Sequence[torch.Tensor]) -> dict:
    """A parameter tree from its leaves in ``Model.leaves`` order: per cell
    ``w_x``, ``w_h``, ``b``, then the head's ``w``, ``b``."""
    n = (len(leaves) - 2) // 3
    return {"cells": [dict(zip(("w_x", "w_h", "b"), leaves[3 * i:3 * i + 3]))
                      for i in range(n)],
            "head": {"w": leaves[-2], "b": leaves[-1]}}


class Model:
    """The emulator over a parameter tree of HWIO f32 tensors."""

    def __init__(self, params, config: dict, stats: Dict[str, object],
                 static: Optional[np.ndarray] = None, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.params = params
        self.config = config
        self.precision = precision
        dev = params["head"]["w"].device
        c = len(stats["x_mean"])
        self.x_mean = torch.as_tensor(stats["x_mean"], dtype=torch.float32, device=dev).view(c, 1, 1)
        self.x_std = torch.as_tensor(stats["x_std"], dtype=torch.float32, device=dev).view(c, 1, 1)
        self.y_mean = float(stats["y_mean"])
        self.y_std = float(stats["y_std"])
        self.static = None if static is None else torch.as_tensor(zscore_maps(static), device=dev)

    def leaves(self) -> List[torch.Tensor]:
        leaves = [t for c in self.params["cells"] for t in (c["w_x"], c["w_h"], c["b"])]
        return leaves + [self.params["head"]["w"], self.params["head"]["b"]]

    def kernels(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per cell the combined kernel as OIHW and the bias."""
        return [(torch.cat([c["w_x"], c["w_h"]], dim=2).permute(3, 2, 0, 1), c["b"])
                for c in self.params["cells"]]

    def prep(self, x: torch.Tensor) -> torch.Tensor:
        """Raw frames (..., C, H, W) -> normalized, static maps appended, padded."""
        x = (x.float() - self.x_mean) / self.x_std
        if self.static is not None:
            x = torch.cat([x, self.static.expand(*x.shape[:-3], *self.static.shape)], dim=-3)
        return pad_grid(x, self.config["padded"])

    def zero_state(self, batch: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        hp, wp = self.config["padded"]
        return [(torch.zeros(batch, h, hp, wp, device=device),
                 torch.zeros(batch, h, hp, wp, device=device))
                for h in self.config["hidden_channels"]]

    def step(self, kernels, x: torch.Tensor, state):
        """One frame (B, C, Hp, Wp) through every cell; the new state."""
        q = self.precision
        new = []
        inp = x
        for (w, b), (h, c) in zip(kernels, state):
            gates = F.conv2d(round_to(torch.cat([inp, h], dim=1), q), round_to(w, q), b,
                             padding=w.shape[-1] // 2)
            gates = round_cotangent(gates, q)
            i, f, g, o = gates.chunk(4, dim=1)
            c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            new.append((h, c))
            inp = h
        return new

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """(B, h, Hp, Wp) -> normalized prediction (B, H, W) on the grid."""
        q = self.precision
        w = self.params["head"]["w"].permute(3, 2, 0, 1)
        p = F.conv2d(round_to(h, q), round_to(w, q), self.params["head"]["b"])
        return crop_grid(p[:, 0], self.config["grid"])

    def rollout(self, forcings: torch.Tensor, state=None):
        """Serving: raw forcings (B, T, C, H, W) from ``state`` (NCHW per-layer
        (h, c), zeros when None) -> (predictions (B, T, H, W) in physical
        units, final state)."""
        with torch.no_grad(), exact_f32():
            kernels = self.kernels()
            if state is None:
                state = self.zero_state(forcings.shape[0], forcings.device)
            preds = []
            for t in range(forcings.shape[1]):
                state = self.step(kernels, self.prep(forcings[:, t]), state)
                preds.append(self.head(state[-1][0]) * self.y_std + self.y_mean)
            return torch.stack(preds, dim=1), state

    def loss(self, x_raw: torch.Tensor, y_raw: torch.Tensor) -> torch.Tensor:
        """Training: MSE + L1 of the windows' (B, T, C, H, W) last prediction
        against the normalized target (B, H, W)."""
        kernels = self.kernels()
        state = self.zero_state(x_raw.shape[0], x_raw.device)
        for t in range(x_raw.shape[1]):
            state = self.step(kernels, self.prep(x_raw[:, t]), state)
        pred = self.head(state[-1][0])
        y = (y_raw.float() - self.y_mean) / self.y_std
        return torch.mean((y - pred) ** 2) + torch.mean(torch.abs(y - pred))

    def gradients(self, x_raw: torch.Tensor, y_raw: torch.Tensor) -> List[torch.Tensor]:
        """The loss's gradient by leaf (``leaves`` order) at these weights."""
        with exact_f32():
            return list(torch.autograd.grad(self.loss(x_raw, y_raw), self.leaves()))


class Trainer:
    """The reference's training steps: the loss, autograd, then Adam
    (eps 1e-8) over the tree's leaves, as the configuration states it."""

    def __init__(self, model: Model, lr: float, betas: Sequence[float]):
        self.model = model
        self.leaves = model.leaves()
        for t in self.leaves:
            t.requires_grad_(True)
        self.betas = tuple(betas)
        self.opt = torch.optim.Adam(self.leaves, lr=lr, betas=self.betas, eps=1e-8,
                                    foreach=False)

    def step(self, x_raw: torch.Tensor, y_raw: torch.Tensor) -> float:
        with exact_f32():
            self.opt.zero_grad(set_to_none=True)
            loss = self.model.loss(x_raw, y_raw)
            loss.backward()
            self.opt.step()
        return float(loss.detach())

    def first_moments(self) -> List[torch.Tensor]:
        return [self.opt.state[t]["exp_avg"].detach().clone() for t in self.leaves]
