"""ConvLSTM forward (counterpart of nasa_niswan_tpu/models/convlstm.py).

Stacked ConvLSTM cells scanned over time, then a 1x1 head on the last
layer's h.  The numerical contract is the JAX package's:

  * gate order i, f, g, o along channels; c' = c*sigmoid(f) +
    sigmoid(i)*tanh(g); h' = sigmoid(o)*tanh(c');
  * zero initial state unless ``initial_state`` is given;
  * activations NHWC, kernels HWIO, state f32; the gate conv reads its
    operands in ``compute_dtype`` and sums in f32 (as the fused TPU kernel
    does); the head returns a ``compute_dtype`` product promoted to f32 by
    the f32 bias.

Each cell step is one fused-cell call on ``xh = [x; h]`` with the combined
kernel ``[w_x; w_h]``: the CUDA kernel for tensors on the card, its plain
PyTorch version on the CPU (ops/convlstm_cell.py).  The time loop is a
Python loop; the JAX package's TPU policies (``cell_impl``, unroll, remat,
the input-conv hoist) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nasa_niswan_tpu_torch.models.init import torch_conv_init
from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward, gate_update

Params = Dict[str, Any]
CellFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

__all__ = [
    "ConvLSTM",
    "ConvLSTMConfig",
    "convlstm_apply",
    "convlstm_init",
    "convlstm_param_count",
    "gate_update",
    "head_apply",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ConvLSTMConfig:
    in_channels: int = 5
    hidden_channels: Tuple[int, ...] = (64, 32, 16)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3)
    out_channels: int = 1
    compute_dtype: str = "float32"  # or "bfloat16"

    def __post_init__(self):
        if len(self.hidden_channels) != len(self.kernel_sizes):
            raise ValueError("hidden_channels and kernel_sizes must align")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_DTYPES)}, got "
                f"{self.compute_dtype!r}"
            )

    @property
    def num_layers(self) -> int:
        return len(self.hidden_channels)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def convlstm_init(
    generator: torch.Generator, config: ConvLSTMConfig, *, device=None
) -> Params:
    """torch-default conv init of each cell's *combined* [x; h] kernel, then
    split into ``w_x`` / ``w_h``; the same parameter tree as the JAX
    package: {"cells": [{w_x, w_h, b}], "head": {w, b}}, HWIO, f32."""
    cells: List[Params] = []
    in_ch = config.in_channels
    for hidden, k in zip(config.hidden_channels, config.kernel_sizes):
        kernel, bias = torch_conv_init(
            generator, k, k, in_ch + hidden, 4 * hidden, device=device
        )
        cells.append(
            {
                "w_x": kernel[:, :, :in_ch, :].contiguous(),
                "w_h": kernel[:, :, in_ch:, :].contiguous(),
                "b": bias,
            }
        )
        in_ch = hidden
    head_w, head_b = torch_conv_init(
        generator, 1, 1, config.hidden_channels[-1], config.out_channels,
        device=device,
    )
    return {"cells": cells, "head": {"w": head_w, "b": head_b}}


def convlstm_param_count(params: Params) -> int:
    n = sum(t.numel() for cell in params["cells"] for t in cell.values())
    return n + sum(t.numel() for t in params["head"].values())


def head_apply(params: Params, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1x1 head: (B, H, W, hidden) -> (B, H, W, out) f32."""
    return conv2d(
        h.to(dtype), params["head"]["w"].to(dtype), params["head"]["b"]
    ).float()


def _state_tensor(a, device) -> torch.Tensor:
    """A carry leaf as a contiguous f32 tensor on ``device``; numpy leaves
    (a carry handed over from the JAX package) are copied."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32).contiguous()


def convlstm_apply(
    params: Params,
    x: torch.Tensor,
    config: ConvLSTMConfig,
    *,
    return_per_step: bool = False,
    initial_state: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    return_state: bool = False,
    tap_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    cell_fn: CellFn = fused_cell_forward,
):
    """Run the ConvLSTM over a sequence.

    Args:
      x: (B, T, H, W, C) NHWC sequence.
      return_per_step: also return a per-step tap of the last layer's h —
        the head by default, shape (B, T, H, W, out).
      tap_fn: custom per-step tap ``f(h_last) -> ys`` replacing the head tap.
      initial_state: per-layer (h, c), each (B, H, W, hidden); zeros if None.
      return_state: also return the final per-layer (h, c) carry.
      cell_fn: the fused cell ``(xh, c, w, b) -> (h', c')``.  The default
        dispatches by device; ``fused_cell_forward_plain`` runs the plain
        version on any device (the reference the kernel is checked against).

    Returns:
      pred (B, H, W, out) f32, then the taps and the final state if asked.
    """
    dt = config.torch_dtype
    B, T, H, W = x.shape[:4]
    if initial_state is None:
        state = [
            (
                torch.zeros((B, H, W, hc), dtype=torch.float32, device=x.device),
                torch.zeros((B, H, W, hc), dtype=torch.float32, device=x.device),
            )
            for hc in config.hidden_channels
        ]
    else:
        state = [
            (_state_tensor(h, x.device), _state_tensor(c, x.device))
            for h, c in initial_state
        ]
    # the combined [w_x; w_h] kernel in the compute dtype, built once per call
    cells = [
        (
            torch.cat([cell["w_x"], cell["w_h"]], dim=2).to(dt).contiguous(),
            cell["b"].float().contiguous(),
        )
        for cell in params["cells"]
    ]

    taps = []
    for t in range(T):
        inp = x[:, t]
        for li, (w, b) in enumerate(cells):
            h, c = state[li]
            xh = torch.cat([inp.to(dt), h.to(dt)], dim=-1)
            state[li] = cell_fn(xh, c, w, b)
            inp = state[li][0]
        if return_per_step:
            taps.append(
                tap_fn(inp) if tap_fn is not None else head_apply(params, inp, dt)
            )

    out = [head_apply(params, state[-1][0], dt)]
    if return_per_step:
        out.append(torch.stack(taps, dim=1))
    if return_state:
        out.append(state)
    return out[0] if len(out) == 1 else tuple(out)


class ConvLSTM(nn.Module):
    """``nn.Module`` holding the parameter tree; ``forward`` is
    ``convlstm_apply``.  Parameters are named ``cells.<i>.{w_x,w_h,b}`` and
    ``head.{w,b}``, HWIO, like the JAX tree's leaves."""

    def __init__(self, config: ConvLSTMConfig, params: Optional[Params] = None,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = convlstm_init(generator, config, device=device)
        self.cells = nn.ModuleList()
        for cell in params["cells"]:
            m = nn.Module()
            for name in ("w_x", "w_h", "b"):
                m.register_parameter(
                    name, nn.Parameter(cell[name].to(device), requires_grad=False)
                )
            self.cells.append(m)
        self.head = nn.Module()
        for name in ("w", "b"):
            self.head.register_parameter(
                name,
                nn.Parameter(params["head"][name].to(device), requires_grad=False),
            )

    def params(self) -> Params:
        """The functional parameter tree (views of this module's tensors)."""
        return {
            "cells": [
                {"w_x": m.w_x, "w_h": m.w_h, "b": m.b} for m in self.cells
            ],
            "head": {"w": self.head.w, "b": self.head.b},
        }

    def forward(self, x: torch.Tensor, **kwargs):
        return convlstm_apply(self.params(), x, self.config, **kwargs)
