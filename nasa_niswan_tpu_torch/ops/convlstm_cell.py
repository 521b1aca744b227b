"""Fused ConvLSTM cell forward: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``nasa_niswan_tpu/ops/convlstm_pallas2.py::
_cell_kernel_v2`` in its plain mode.  Its other two modes are not ported:
hoisted input gates ``xg`` serve only the JAX package's
``precompute_input_conv``, and the ``emit_gates`` output only its
``bptt_bwd="xla"`` fallback; the port's training backward recomputes the
gates in ``ops/convgrad.py`` instead.  The
kernel is ``csrc/convlstm_cell.cu``: the SAME k x k gate conv of ``xh =
[x; h]``, the gate nonlinearities and the state update in one launch, with
the 4*hidden gate tensor kept in registers.  The TPU kernel's padded-column
margin layout, 128-lane channel padding and f32 partial rolls are TPU
tiling devices; the port runs in the dense NHWC layout and the kernel masks
its own halo at every frame edge.

What bounds it on an H100: at the serving shapes (B=1, 100x154) layer 1 is
an M = 15,400 x N = 256 x K = 3,150 product, about 25 of the ~29 GFLOP of a
step, against ~17 MB of traffic, so the cell is compute-bound.  bf16
operands run on the tensor cores (``mma.sync``, f32 accumulate), held back
by their per-tap weight staging; f32 operands run on the FP32 pipes (see
the .cu file).  ``wgmma`` with TMA-fed tiles is later work.

Dispatch goes by device: a tensor on the CPU runs ``fused_cell_forward_plain``;
any other device goes through the custom op ``niswan::convlstm_cell``,
whose CUDA implementation launches the kernel or raises.  There is no
fallback from the kernel to the plain version.

Beside the forward live the plain building blocks of every backward
(``_elementwise_bwd`` and ``_conv_grads`` of the JAX package):
``elementwise_bwd`` and ``conv_grads``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nasa_niswan_tpu_torch.ops import _build
from nasa_niswan_tpu_torch.ops.conv import conv2d

# Successful launches of the CUDA kernel in this process; chip_smoke.py
# resets it before driving the serving path and reads it after.
launches = 0

_KERNEL_SIZES = (1, 3, 5, 7)
_MAX_HIDDEN = 128  # 4 pixel groups x hidden threads must fit a 512-thread block


def gate_update(
    gates: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM state update from pre-activation gates (channel blocks i,f,g,o)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def fused_cell_forward_plain(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain PyTorch: operands upcast to f32, an f32
    SAME conv, then the state update.  Used for CPU tensors and as the
    reference the kernel is held to on the card."""
    k = w.shape[0]
    gates = conv2d(xh.float(), w.float(), padding=k // 2) + b.float()
    return gate_update(gates, c)


def elementwise_bwd(
    gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of the gate nonlinearities and the state update
    (``_elementwise_bwd`` of nasa_niswan_tpu/ops/convlstm_pallas2.py, without
    its margin mask: every pixel of the dense layout is valid).  Output
    cotangents (dh', dc') -> (f32 pre-activation gate cotangents in i, f, g, o
    order, dc_prev)."""
    hid = c.shape[-1]
    g32 = gates.float()
    i = torch.sigmoid(g32[..., :hid])
    f = torch.sigmoid(g32[..., hid : 2 * hid])
    g = torch.tanh(g32[..., 2 * hid : 3 * hid])
    og = torch.sigmoid(g32[..., 3 * hid :])
    c32 = c.float()
    tc = torch.tanh(c32 * f + i * g)
    dct = dc + dh * og * (1.0 - tc * tc)
    d_i = dct * g * i * (1.0 - i)
    d_f = dct * c32 * f * (1.0 - f)
    d_g = dct * i * (1.0 - g * g)
    d_o = dh * tc * og * (1.0 - og)
    return torch.cat([d_i, d_f, d_g, d_o], dim=-1), dct * f


def conv_grads(
    x: torch.Tensor, w: torch.Tensor, dgates: torch.Tensor, *,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """f32 cotangents (dx, dw) of the linear SAME conv ``conv2d(x, w)`` for
    the output cotangent ``dgates`` (``_conv_grads`` of
    nasa_niswan_tpu/ops/convlstm_pallas2.py); operands are upcast to f32, dx
    is None unless asked for.  NHWC / HWIO in and out.

    dw is one f32 matmul per tap, x's shifted window against dgates: cuDNN's
    f32 weight gradient on an H100 was measured off by 1.6e-2 of its largest
    entry at the training layer-1 shape (B=8, 100x154, 72 -> 256, k=5), and
    the plain version is the kernel's reference."""
    k = w.shape[0]
    p = k // 2
    B, H, W, cin = x.shape
    g2 = dgates.float().reshape(-1, dgates.shape[-1])
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p, p, p))
    dw = torch.stack([
        xp[:, dy : dy + H, dx : dx + W].reshape(-1, cin).T @ g2
        for dy in range(k) for dx in range(k)
    ]).reshape(k, k, cin, -1)
    dx = None
    if need_dx:
        dx = torch.nn.grad.conv2d_input(
            (B, cin, H, W), w.float().permute(3, 2, 0, 1),
            dgates.float().permute(0, 3, 1, 2), padding=p,
        ).permute(0, 2, 3, 1)
    return dx, dw


def check_cell_args(xh, c, w, b) -> None:
    """Raise on what the kernel does not take: xh (B,H,W,Cin) and w
    (k,k,Cin,4*hid) of one dtype, bf16 or f32; c (B,H,W,hid) and b (4*hid,)
    f32; k odd in 1..7; all contiguous and on one device."""
    if xh.dim() != 4 or c.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(
            "expected xh (B,H,W,Cin), c (B,H,W,hid), w (k,k,Cin,4h), b (4h,); "
            f"got {tuple(xh.shape)}, {tuple(c.shape)}, {tuple(w.shape)}, "
            f"{tuple(b.shape)}"
        )
    B, H, W, cin = xh.shape
    hid = c.shape[-1]
    k = w.shape[0]
    if tuple(c.shape[:3]) != (B, H, W) or tuple(w.shape) != (k, k, cin, 4 * hid) \
            or tuple(b.shape) != (4 * hid,):
        raise ValueError(
            f"shape mismatch: xh {tuple(xh.shape)}, c {tuple(c.shape)}, "
            f"w {tuple(w.shape)}, b {tuple(b.shape)}"
        )
    if k not in _KERNEL_SIZES:
        raise ValueError(f"kernel size {k} not in {_KERNEL_SIZES}")
    if hid > _MAX_HIDDEN:
        raise ValueError(f"hidden channels {hid} > {_MAX_HIDDEN}")
    if xh.dtype not in (torch.bfloat16, torch.float32) or w.dtype != xh.dtype:
        raise TypeError(
            f"xh and w must share dtype bf16 or f32; got {xh.dtype}, {w.dtype}"
        )
    if c.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"c and b must be f32; got {c.dtype}, {b.dtype}")
    if not all(t.device == xh.device for t in (c, w, b)):
        raise ValueError("xh, c, w and b must be on one device")
    if not all(t.is_contiguous() for t in (xh, c, w, b)):
        raise ValueError("xh, c, w and b must be contiguous")


@torch.library.custom_op(
    "niswan::convlstm_cell", mutates_args=(), device_types="cuda"
)
def _convlstm_cell_cuda(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    lib = _build.load_kernels()
    fn = (
        lib.niswan_convlstm_cell_bf16
        if xh.dtype == torch.bfloat16
        else lib.niswan_convlstm_cell_f32
    )
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    B, H, W, cin = xh.shape
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = fn(
            xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(),
            B, H, W, cin, c.shape[-1], w.shape[0], stream,
        )
    if err:
        raise RuntimeError(
            "convlstm_cell kernel launch failed: "
            f"{lib.niswan_error_string(err).decode()} (cudaError {err})"
        )
    launches += 1
    return h_out, c_out


@_convlstm_cell_cuda.register_fake
def _(xh, c, w, b):
    return torch.empty_like(c), torch.empty_like(c)


def fused_cell_forward(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused cell step; returns (h', c') f32 (B,H,W,hid).  CPU tensors
    run the plain version, every other device the custom op."""
    check_cell_args(xh, c, w, b)
    if xh.device.type == "cpu":
        return fused_cell_forward_plain(xh, c, w, b)
    return torch.ops.niswan.convlstm_cell(xh, c, w, b)
