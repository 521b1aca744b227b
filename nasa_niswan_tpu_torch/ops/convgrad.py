"""Fused ConvLSTM cell backward and the SAME data-gradient conv: the
hand-written CUDA kernels and their plain PyTorch versions.

Replaces the TPU kernels of ``nasa_niswan_tpu/ops/convgrad_pallas.py``:

* ``fused_cell_bwd`` (B2, ``_cell_bwd_kernel`` via ``fused_cell_bwd_v2``):
  recomputes the gates of one cell step from (xh, w, b), applies the
  elementwise backward of the nonlinearities and the state update, and
  reduces the weight and bias gradients over every pixel.  Kernel:
  ``csrc/cell_bwd.cu`` (gate recompute on the forward's mainloop; dW on
  ``wgmma`` for every bf16 shape, split over a fixed number of pixel slots
  and summed in a fixed order; no atomics, so reruns are bit-identical).
* ``conv_same`` (B3, ``_conv_same_kernel`` via ``conv_same_v2``): a SAME
  k x k conv with an f32 output; on the flipped, transposed cell kernel it is
  the data gradient dxh.  Kernel: ``csrc/conv_same.cu``, whose bf16 entry
  takes channel counts padded to a multiple of 8 (``_mma_operands``).
* ``cell_grads``: B2 then B3 on ``w_flip = flip(w, (0, 1)).swapaxes(2, 3)``,
  the complete per-cell backward (``cell_grads_pallas``).  With B1 in plain
  mode it is also the counterpart of the v1 cell's VJP ``_fused_bwd``
  (``nasa_niswan_tpu/ops/convlstm_pallas.py``, B4), which recomputes the
  gates the same way.
* ``conv_dw``: B2's weight-gradient kernels on their own (``niswan::conv_dw``),
  for a gate cotangent computed elsewhere: the per-cell route's dw
  (``ops/convlstm_cell.FusedCell``), where the JAX package runs XLA's conv
  gradient.

The TPU kernels' padded-column margin layout, 128-lane channel padding and
``pltpu.roll`` are TPU tiling devices; the port runs in the dense NHWC /
HWIO layout, and every pixel is valid, so nothing is masked.

Roundings kept from the reference: ``dgates`` is rounded to the compute
dtype (the dtype of xh) before both the dW product and the data-gradient
conv; ``db`` sums the f32 gate cotangents; ``dc_prev`` is f32.  dW is an f32
sum of compute-dtype operands, as the TPU kernel computes it.

Dispatch goes by device, with no fallback: CPU tensors run the plain
versions; any other device goes through the custom ops ``niswan::cell_bwd``
and ``niswan::conv_same``, whose CUDA implementations launch the kernels or
raise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from nasa_niswan_tpu_torch.ops import _build
from nasa_niswan_tpu_torch.ops.convlstm_cell import (
    _KERNEL_SIZES,
    _raise_on,
    check_cell_args,
    dw_per_tap,
    elementwise_bwd,
    packed_weights,
)
from nasa_niswan_tpu_torch.ops.conv import conv2d

# Launches of each kernel in this process (one per op call); chip_smoke.py
# resets them before driving the training path and reads them after.
cell_bwd_launches = 0
conv_same_launches = 0
dw_launches = 0
recompute_launches = 0  # B2's part (a) alone: timing only, on no main path
# dw_wgmma_launches is a sub-count of the dW launches (one in each
# cell_bwd launch and each conv_dw launch): those that ran the wgmma kernel
dw_wgmma_launches = 0
LAUNCH_COUNTERS = ("cell_bwd_launches", "conv_same_launches", "dw_launches",
                   "recompute_launches", "dw_wgmma_launches")

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---- B2: fused cell backward ------------------------------------------------

def cell_bwd_recompute_plain(xh, c, dh, dc, w, b):
    """B2's part (a) in plain PyTorch: operands upcast to f32, an f32 gate
    conv, the elementwise backward.  Returns (dgates in xh's dtype, dc_prev
    f32, db (4h,) f32, the sum of the f32 dgates)."""
    gates = conv2d(xh.float(), w.float(), padding=w.shape[0] // 2) + b.float()
    dgates32, dc_prev = elementwise_bwd(gates, c, dh, dc)
    return dgates32.to(xh.dtype), dc_prev, dgates32.sum(dim=(0, 1, 2))


def fused_cell_bwd_plain(xh, c, dh, dc, w, b) -> Grads:
    """The kernel's math in plain PyTorch (``_cell_bwd_reference``): part
    (a), then the f32 weight gradient of the compute-dtype operands.
    Returns (dgates in xh's dtype, dc_prev f32, dw (k,k,Cin,4h) f32, db
    (4h,) f32)."""
    dgates, dc_prev, db = cell_bwd_recompute_plain(xh, c, dh, dc, w, b)
    return dgates, dc_prev, dw_per_tap(xh, dgates, w.shape[0]), db


def _check_bwd_args(xh, c, dh, dc, w, b) -> None:
    check_cell_args(xh, c, w, b)
    for name, t in (("dh", dh), ("dc", dc)):
        if t.shape != c.shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be f32 of c's shape {tuple(c.shape)}; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != xh.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on xh's device")


def _cell_bwd_launch(xh, c, dh, dc, w, b, with_dw: bool):
    """One call of the B2 library function: (dgates, dc_prev, dw or None,
    db); without dw only the gate recompute (a) and db run."""
    lib = _build.load_kernels()
    bf16 = xh.dtype == torch.bfloat16
    B, H, W, cin = xh.shape
    hid = c.shape[-1]
    k = w.shape[0]
    n_work = lib.niswan_cell_bwd_workspace(
        int(bf16), xh.data_ptr(), B, H, W, cin, hid, k
    )
    if n_work < 0:
        raise ValueError(
            f"no cell backward kernel for xh {tuple(xh.shape)}, hid {hid}, k {k}"
        )
    dgates = torch.empty((B, H, W, 4 * hid), dtype=xh.dtype, device=xh.device)
    dc_prev = torch.empty_like(c)
    dw = torch.empty(w.shape, dtype=torch.float32, device=xh.device) if with_dw else None
    wpack = packed_weights(w)
    db = torch.empty((4 * hid,), dtype=torch.float32, device=xh.device)
    work = torch.empty((n_work,), dtype=torch.float32, device=xh.device)
    fn = lib.niswan_cell_bwd_bf16 if bf16 else lib.niswan_cell_bwd_f32
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = fn(
            xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(),
            None if dw is None else dw.data_ptr(), db.data_ptr(), work.data_ptr(),
            None if wpack is None else wpack.data_ptr(),
            B, H, W, cin, hid, k, stream,
        )
    _raise_on(err, "cell_bwd", lib)
    return dgates, dc_prev, dw, db


@torch.library.custom_op("niswan::cell_bwd", mutates_args=(), device_types="cuda")
def _cell_bwd_cuda(
    xh: torch.Tensor, c: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor,
    w: torch.Tensor, b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    global cell_bwd_launches, dw_wgmma_launches
    out = _cell_bwd_launch(xh, c, dh, dc, w, b, True)
    cell_bwd_launches += 1
    dw_wgmma_launches += xh.dtype == torch.bfloat16  # bf16 dW always runs wgmma
    return out


@_cell_bwd_cuda.register_fake
def _(xh, c, dh, dc, w, b):
    B, H, W, _ = xh.shape
    n4 = w.shape[-1]
    return (
        xh.new_empty((B, H, W, n4)),
        torch.empty_like(c),
        w.new_empty(w.shape, dtype=torch.float32),
        w.new_empty((n4,), dtype=torch.float32),
    )


def fused_cell_bwd(xh, c, dh, dc, w, b) -> Grads:
    """Cell backward without the data gradient: (dgates, dc_prev, dw, db).
    xh (B,H,W,Cin) and w (k,k,Cin,4h) bf16 or f32; c, dh, dc (B,H,W,h) and b
    f32.  CPU tensors run the plain version, every other device the kernel."""
    _check_bwd_args(xh, c, dh, dc, w, b)
    if xh.device.type == "cpu":
        return fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    return torch.ops.niswan.cell_bwd(xh, c, dh, dc, w, b)


def cell_bwd_recompute(xh, c, dh, dc, w, b):
    """B2's part (a) alone: (dgates, dc_prev, db), the gate recompute on the
    cell's mainloop and the elementwise backward, without dW.  No training
    route calls it; ``chip_smoke.py`` and ``scripts/time_cell.py`` time
    it.  CPU tensors run the plain version, every other device the kernel
    (each launch counted in ``recompute_launches``)."""
    global recompute_launches
    _check_bwd_args(xh, c, dh, dc, w, b)
    if xh.device.type == "cpu":
        return cell_bwd_recompute_plain(xh, c, dh, dc, w, b)
    dgates, dc_prev, _, db = _cell_bwd_launch(xh, c, dh, dc, w, b, False)
    recompute_launches += 1
    return dgates, dc_prev, db


# ---- B3: SAME conv, f32 out --------------------------------------------------

def conv_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 SAME conv of the upcast operands: (B,H,W,Cin) x (k,k,Cin,Cout) ->
    (B,H,W,Cout) f32."""
    return conv2d(x.float(), w.float(), padding=w.shape[0] // 2)


def _check_conv_args(x, w) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(
            f"expected x (B,H,W,Cin), w (k,k,Cin,Cout); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}"
        )
    if w.shape[0] not in _KERNEL_SIZES:
        raise ValueError(f"kernel size {w.shape[0]} not in {_KERNEL_SIZES}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must share dtype bf16 or f32; got {x.dtype}, {w.dtype}"
        )
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous on one device")


def _mma_operands(x: torch.Tensor, w: torch.Tensor):
    """bf16 operands as the tensor-core kernel takes them: x's channels and
    w's input channels zero-padded to a multiple of 8, w's output channels
    likewise (the kernel's weight row pitch), both 16-byte aligned.  A copy
    is made only where that is not so already: w' of a cell with Cin 70 or
    126 (0.9 MB), or the frames of the hoisted conv at C = 62."""
    pc, po = -x.shape[-1] % 8, -w.shape[-1] % 8
    if pc or x.data_ptr() % 16:
        x = F.pad(x, (0, pc)) if pc else x.clone()
    if pc or po or w.data_ptr() % 16:
        w = F.pad(w, (0, po, 0, pc)) if pc or po else w.clone()
    return x, w


@torch.library.custom_op("niswan::conv_same", mutates_args=(), device_types="cuda")
def _conv_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global conv_same_launches
    lib = _build.load_kernels()
    B, H, W, _ = x.shape
    k, cout = w.shape[0], w.shape[-1]
    out = torch.empty((B, H, W, cout), dtype=torch.float32, device=x.device)
    fn = lib.niswan_conv_same_f32
    if x.dtype == torch.bfloat16:
        x, w = _mma_operands(x, w)
        fn = lib.niswan_conv_same_bf16
    cin = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 B, H, W, cin, cout, k, stream)
    _raise_on(err, "conv_same", lib)
    conv_same_launches += 1
    return out


@_conv_same_cuda.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:3], w.shape[-1]), dtype=torch.float32)


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME k x k conv, f32 out.  CPU tensors run the plain version, every
    other device the kernel."""
    _check_conv_args(x, w)
    if x.device.type == "cpu":
        return conv_same_plain(x, w)
    return torch.ops.niswan.conv_same(x, w)


# ---- B2's dW on its own ------------------------------------------------------

@torch.library.custom_op("niswan::conv_dw", mutates_args=(), device_types="cuda")
def _conv_dw_cuda(x: torch.Tensor, dgates: torch.Tensor, k: int) -> torch.Tensor:
    global dw_launches, dw_wgmma_launches
    lib = _build.load_kernels()
    bf16 = x.dtype == torch.bfloat16
    B, H, W, cin = x.shape
    n = dgates.shape[-1]
    n_work = lib.niswan_conv_dw_workspace(
        int(bf16), x.data_ptr(), dgates.data_ptr(), B, H, W, cin, n, k
    )
    if n_work < 0:
        raise ValueError(f"no dw kernel for x {tuple(x.shape)}, N {n}, k {k}")
    dw = torch.empty((k, k, cin, n), dtype=torch.float32, device=x.device)
    work = torch.empty((n_work,), dtype=torch.float32, device=x.device)
    fn = lib.niswan_conv_dw_bf16 if bf16 else lib.niswan_conv_dw_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dgates.data_ptr(), dw.data_ptr(), work.data_ptr(),
                 B, H, W, cin, n, k, stream)
    _raise_on(err, "conv_dw", lib)
    dw_launches += 1
    dw_wgmma_launches += bf16  # bf16 dW always runs wgmma
    return dw


@_conv_dw_cuda.register_fake
def _(x, dgates, k):
    return x.new_empty((k, k, x.shape[-1], dgates.shape[-1]), dtype=torch.float32)


def dw_plan(dtype: torch.dtype, B, H, W, cin, n, k) -> str:
    """Which kernel the dW launches (``conv_dw`` and B2's) take for these
    shapes, as the library plans them (builds the library): ``"wgmma"``
    (bf16, the tensor cores) or ``"fp32"`` (the FP32 pipes); raises if no
    kernel takes them."""
    plan = _build.load_kernels().niswan_conv_dw_plan(
        int(dtype == torch.bfloat16), B, H, W, cin, n, k)
    if plan < 0:
        raise ValueError(f"no dw kernel for B={B} H={H} W={W} Cin={cin} N={n} k={k}")
    return "wgmma" if plan == 1 else "fp32"



def conv_dw(x: torch.Tensor, dgates: torch.Tensor, k: int) -> torch.Tensor:
    """f32 weight gradient (k,k,Cin,N) of the SAME k x k conv of x
    (B,H,W,Cin) for the output cotangent dgates (B,H,W,N) of x's dtype.
    CPU tensors run the plain version (one f32 matmul per tap), every other
    device the kernel: ``wgmma`` for bf16 at any Cin and N, the FP32 pipes
    for f32."""
    if x.dim() != 4 or dgates.dim() != 4 or x.shape[:3] != dgates.shape[:3]:
        raise ValueError(
            f"expected x (B,H,W,Cin), dgates (B,H,W,N); got {tuple(x.shape)}, "
            f"{tuple(dgates.shape)}"
        )
    if k not in _KERNEL_SIZES:
        raise ValueError(f"kernel size {k} not in {_KERNEL_SIZES}")
    if x.dtype not in (torch.bfloat16, torch.float32) or dgates.dtype != x.dtype:
        raise TypeError(
            f"x and dgates must share dtype bf16 or f32; got {x.dtype}, {dgates.dtype}"
        )
    if dgates.device != x.device or not (x.is_contiguous() and dgates.is_contiguous()):
        raise ValueError("x and dgates must be contiguous on one device")
    if x.device.type == "cpu":
        return dw_per_tap(x, dgates, k)
    return torch.ops.niswan.conv_dw(x, dgates, k)


# ---- the per-cell backward ---------------------------------------------------

def flip_kernel(w: torch.Tensor) -> torch.Tensor:
    """w' = flip(w, (0, 1)).swapaxes(2, 3): conv_same(dgates, w') is the
    data gradient of the SAME conv with w."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


def cell_grads(xh, c, dh, dc, w, b) -> Grads:
    """Complete per-cell backward (``cell_grads_pallas``): (dxh f32, dc_prev
    f32, dw f32, db f32) from the output cotangents, via B2 then B3."""
    dgates, dc_prev, dw, db = fused_cell_bwd(xh, c, dh, dc, w, b)
    dxh = conv_same(dgates, flip_kernel(w).to(dgates.dtype))
    return dxh, dc_prev, dw, db


def cell_grads_plain(xh, c, dh, dc, w, b) -> Grads:
    """``cell_grads`` through the plain versions on any device."""
    dgates, dc_prev, dw, db = fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    dxh = conv_same_plain(dgates, flip_kernel(w).to(dgates.dtype))
    return dxh, dc_prev, dw, db
