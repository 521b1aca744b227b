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
Python loop.  Of the JAX package's TPU policies, ``remat`` and the
input-conv hoist ``precompute_input_conv`` have counterparts, because they
pick the training route; ``cell_impl``, the unrolls and ``bptt_fwd`` do
not: a CUDA tensor always runs the kernels.

Training routes, JAX's rule (nasa_niswan_tpu/models/convlstm.py:332-338):

* whole-scan BPTT: when grad is enabled, something being differentiated
  requires it, ``config.remat`` is set, and no per-step taps, ``tap_fn`` or
  hoist are asked for, the layers and time loop run as one autograd
  Function (ops/convlstm_bptt.py), whose backward recomputes the gates
  (kernels B2 and B3 on the card).  ``build_model`` sets ``remat``, as the
  JAX package's does, so the windowed trainer takes this route.
* per-cell: otherwise every differentiated cell is the custom VJP
  ``FusedCell`` (``FusedCellXg`` at layer 0 with the hoist), whose forward
  keeps the gates (the ``emit_gates`` launch) and whose backward runs B3
  for dxh and B2's dW kernels.  It stores the gates, xh and c of every
  cell: about 219 MB per step at the canonical training shapes.
* the hoist: layer 0's input conv runs once over all T*B frames, outside
  the cell kernel as in the JAX package, and its f32 sums are rounded to
  the compute dtype; the kernel's ``xg`` mode then convolves h with
  ``w_h`` only.  The conv is the SAME-conv kernel B3 (``conv_same``), its
  weight gradient B2's dW kernel (``conv_dw``) and its data gradient B3 on
  the flipped kernel.  With cuDNN's f32 conv and weight gradient there,
  the hoisted route's T=8 gradients on the H100 were 1.7e-4 of their norm
  from eager autograd (3.3e-7 with B3 and dW; PERF.md).

The head, crop and loss stay plain autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.models.init import torch_conv_init
from nasa_niswan_tpu_torch.ops.conv import conv2d
from nasa_niswan_tpu_torch.ops.convgrad import cell_grads, conv_dw, conv_same, flip_kernel
from nasa_niswan_tpu_torch.ops.convlstm_bptt import (
    cells_step,
    combined_cells,
    scan_cells,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import (
    fused_cell_forward,
    fused_cell_forward_plain,
    gate_update,
)

Params = Dict[str, Any]
CellFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
GradsFn = Callable[..., Tuple[torch.Tensor, ...]]

__all__ = [
    "ConvLSTM",
    "ConvLSTMConfig",
    "cell_weights",
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
    remat: bool = False  # differentiate through the whole-scan BPTT (no
    # per-step residuals) instead of the per-cell route; JAX's default

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


class _HoistedConv(torch.autograd.Function):
    """The SAME conv of the hoist, B3 with its f32 output rounded to x's
    dtype; backward: dw from B2's dW kernels, dx from B3 on the flipped
    kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv_same(x, w).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv_same(g, flip_kernel(w)) if ctx.needs_input_grad[0] else None
        return dx, conv_dw(x, g, w.shape[0])


def cell_weights(params: Params, config: ConvLSTMConfig, hoist: bool = False) -> Params:
    """The kernels the time loop reads, in the compute dtype: per layer the
    combined ``[w_x; w_h]`` and the f32 bias (``combined_cells``), and with
    the hoist layer 0's ``w_x`` and ``w_h`` alone.  ``convlstm_apply`` makes
    them on every call; a caller that replays a captured step loop
    (rollout/graph.py) makes them once, before the capture."""
    dt = config.torch_dtype
    out = {"cells": combined_cells(params, dt)}
    if hoist:
        cell0 = params["cells"][0]
        out["w_x0"] = cell0["w_x"].to(dt).contiguous()
        out["w_h0"] = cell0["w_h"].to(dt).contiguous()
    return out


def hoist_input_conv(
    w: torch.Tensor, x: torch.Tensor, config: ConvLSTMConfig, *, eager: bool = False
) -> torch.Tensor:
    """Layer 0's input conv over every frame at once: (B, T, H, W, C) ->
    time-major (T, B, H, W, 4*hidden0) in the compute dtype (the JAX
    package's ``precompute_input_conv``, a (T*B)-batched conv whose output
    is rounded to the compute dtype), with ``w`` layer 0's ``w_x`` in the
    compute dtype (``cell_weights``).  Differentiable through
    ``_HoistedConv``, or through eager autograd of the conv if ``eager``."""
    dt = config.torch_dtype
    B, T, H, W, C = x.shape
    flat = x.transpose(0, 1).reshape(T * B, H, W, C).to(dt).contiguous()
    if eager:
        xg = conv2d(flat, w, padding=w.shape[0] // 2)
    else:
        xg = _HoistedConv.apply(flat, w)
    return xg.reshape(T, B, H, W, -1).contiguous()


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
    precompute_input_conv: bool = False,
    cell_fn: CellFn = fused_cell_forward,
    grads_fn: Optional[GradsFn] = cell_grads,
    weights: Optional[Params] = None,
):
    """Run the ConvLSTM over a sequence.

    Args:
      x: (B, T, H, W, C) NHWC sequence, or a tuple of such parts whose
        channel concatenation is each step's input, made inside the time
        loop (the shared meteorology of rollout/multitracer.py).
      return_per_step: also return a per-step tap of the last layer's h —
        the head by default, shape (B, T, H, W, out).
      tap_fn: custom per-step tap ``f(h_last) -> ys`` replacing the head tap.
      initial_state: per-layer (h, c), each (B, H, W, hidden); zeros if None.
      return_state: also return the final per-layer (h, c) carry.
      precompute_input_conv: hoist layer 0's input conv out of the time
        loop (``hoist_input_conv``); layer 0 then runs the kernel's xg mode.
      cell_fn: the fused cell ``(xh, c, w, b, xg=None) -> (h', c')``.  The
        default dispatches by device and takes the per-cell autograd route
        when differentiating; ``fused_cell_forward_plain`` runs the plain
        version on any device, and eager autograd through it is the oracle
        (with the hoist, its input conv is then an eager conv too).
      grads_fn: the per-cell backward ``(xh, c, dh, dc, w, b) -> (dxh,
        dc_prev, dw, db)`` of the whole-scan BPTT (training route with
        ``config.remat``, see the module docstring):
        ``ops/convgrad.cell_grads`` dispatches by device,
        ``cell_grads_plain`` runs the plain versions.  None never takes the
        whole-scan BPTT: with the plain ``cell_fn``, the eager oracle.
      weights: ``cell_weights(params, config, precompute_input_conv)`` made
        by the caller; None makes them here.

    Returns:
      pred (B, H, W, out) f32, then the taps and the final state if asked.
    """
    dt = config.torch_dtype
    parts = x if isinstance(x, tuple) else (x,)
    if precompute_input_conv and len(parts) > 1:
        raise ValueError("precompute_input_conv needs a single input part")
    x = parts[0]
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
    leaves = [t for cell in params["cells"] for t in cell.values()]
    leaves += [t for hc in state for t in hc] + list(parts)
    taps = []
    if (
        config.remat
        and grads_fn is not None
        and torch.is_grad_enabled()
        and any(t.requires_grad for t in leaves)
        and not return_per_step
        and tap_fn is None
        and not precompute_input_conv
    ):
        xs = torch.cat([p.to(dt) for p in parts], dim=-1) if len(parts) > 1 else x
        state = scan_cells(params, xs.to(dt), state, dt, cell_fn, grads_fn)
    else:
        if weights is None:
            weights = cell_weights(params, config, precompute_input_conv)
        cells = weights["cells"]
        if precompute_input_conv:
            # unbound once: the backward stacks the T step gradients in one
            # pass, where indexing xg[t] would add each into a zero-filled
            # gradient of the whole (T, B, H, W, 4*hidden0) tensor
            eager = cell_fn is fused_cell_forward_plain
            xg = hoist_input_conv(weights["w_x0"], x, config, eager=eager).unbind(0)
            w_h0 = weights["w_h0"]
        if len(parts) > 1:
            x_steps = [torch.cat(ps, dim=-1)
                       for ps in zip(*(p.to(dt).unbind(1) for p in parts))]
        else:
            x_steps = x.unbind(1)
        for t in range(T):
            if precompute_input_conv:
                h0, c0 = state[0]
                first = cell_fn(h0.to(dt), c0, w_h0, cells[0][1], xg[t])
                state = [first] + cells_step(cells[1:], first[0], state[1:], dt, cell_fn)
            else:
                state = cells_step(cells, x_steps[t], state, dt, cell_fn)
            if return_per_step:
                h_last = state[-1][0]
                taps.append(
                    tap_fn(h_last) if tap_fn is not None
                    else head_apply(params, h_last, dt)
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
                m.register_parameter(name, nn.Parameter(cell[name].to(device)))
            self.cells.append(m)
        self.head = nn.Module()
        for name in ("w", "b"):
            self.head.register_parameter(
                name, nn.Parameter(params["head"][name].to(device))
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
