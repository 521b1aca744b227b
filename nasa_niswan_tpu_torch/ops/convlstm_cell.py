"""Fused ConvLSTM cell forward: the hand-written CUDA kernel in its three
modes, their plain PyTorch versions, and the per-cell training route.

Replaces the TPU kernel ``nasa_niswan_tpu/ops/convlstm_pallas2.py::
_cell_kernel_v2`` (B1) in all three of its modes, and, in the plain mode,
the v1 kernel ``nasa_niswan_tpu/ops/convlstm_pallas.py::_cell_kernel`` (B4),
which computes the same cell in the same standard layout:

* plain: (h', c') from ``xh = [x; h]`` and the combined kernel; serving and
  the whole-scan BPTT's forward run it, on the pair (x, h) where they lie
  (``fused_cell_forward``: the kernel stages [x; h] itself, with no
  concatenated copy written before it);
* ``emit_gates``: also the pre-activation gates in the compute dtype, the
  residual of the per-cell custom VJP ``_fused_cell_v2``.  Every cell that
  is differentiated outside the whole-scan BPTT takes that VJP: ``remat``
  off (``ConvLSTMConfig``'s default), per-step taps or a ``tap_fn``, and
  the hoisted input conv;
* ``xg``: layer 0 with the input conv hoisted out of the time loop
  (``precompute_input_conv``): the kernel convolves h with ``w_h`` only and
  adds the precomputed input gates ``xg``; with ``emit_gates`` too when
  training (``_fused_cell_v2_xg``).

The kernel is ``csrc/convlstm_cell.cu``: the SAME k x k gate conv, the gate
nonlinearities and the state update in one launch, with the 4*hidden gate
tensor kept in registers unless ``emit_gates`` asks for it.  The TPU
kernel's padded-column margin layout, 128-lane channel padding and f32
partial rolls are TPU tiling devices; the port runs in the dense NHWC
layout and the kernel masks its own halo at every frame edge.

What bounds it on an H100: at the serving shapes (B=1, 100x154) layer 1 is
an M = 15,400 x N = 256 x K = 3,150 product, about 25 of the ~29 GFLOP of a
step, against ~17 MB of traffic, so the cell is compute-bound; the gate
output adds 4*hidden compute-dtype values per pixel (7.9 MB at layer 1,
B=1, bf16).  bf16 operands at hidden 8/16/32/64 run on the tensor cores
(``wgmma``, the weights streamed through an asynchronous shared-memory
ring; ``csrc/cell_mainloop.cuh`` says how), f32 operands on the FP32 pipes.
``cell_plan`` says which a shape takes.

Dispatch goes by device: a tensor on the CPU runs the plain version; any
other device goes through the custom ops ``niswan::convlstm_cell``,
``niswan::convlstm_cell_gates`` and ``niswan::convlstm_cell_xg``, whose
CUDA implementations launch the kernel or raise.  There is no fallback
from the kernel to the plain version.

The per-cell route: ``fused_cell_forward`` takes the autograd Function
``FusedCell`` (or ``FusedCellXg`` with hoisted gates) when grad is enabled
and an input requires it.  Its forward is the ``emit_gates`` launch; its
backward (``_v2_bwd``) applies ``elementwise_bwd`` to the kept gates, then
takes dxh from the SAME conv kernel B3 on the flipped kernel and dw from
B2's weight-gradient kernels (``ops/convgrad.py``); db sums the f32 gate
cotangents.  Without grad, serving keeps the plain launch, which writes no
gates.

Beside the forward live the plain building blocks of every backward
(``_elementwise_bwd`` and the weight half of ``_conv_grads`` of the JAX
package): ``elementwise_bwd`` and ``dw_per_tap``.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from nasa_niswan_tpu_torch.ops import _build
from nasa_niswan_tpu_torch.ops.conv import conv2d

# Successful launches of the CUDA kernel in this process, by mode (a launch
# with both xg and emit_gates on counts once, under gates_launches);
# chip_smoke.py resets them before driving a path and reads them after.
# parts_launches is a sub-count of launches: the plain launches that staged
# their input from the two tensors (x, h).
launches = 0
gates_launches = 0
xg_launches = 0
parts_launches = 0
LAUNCH_COUNTERS = ("launches", "gates_launches", "xg_launches", "parts_launches")

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


def _gates_plain(xh, w, b, xg):
    """f32 pre-activation gates: an f32 SAME conv of the upcast operands,
    plus b, plus the upcast hoisted gates ``xg`` when given."""
    gates = conv2d(xh.float(), w.float(), padding=w.shape[0] // 2) + b.float()
    return gates if xg is None else gates + xg.float()


def join_xh(xh, dtype: torch.dtype) -> torch.Tensor:
    """A cell's input as one tensor: ``xh`` itself, or the pair (x, h) that
    ``cells_step`` hands a cell concatenated as ``[x; h]`` in ``dtype``."""
    if isinstance(xh, tuple):
        x, h = xh
        return torch.cat([x.to(dtype), h.to(dtype)], dim=-1)
    return xh


def fused_cell_forward_plain(
    xh, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain PyTorch (plain and ``xg`` modes): operands
    upcast to f32, an f32 SAME conv, then the state update; ``xh`` one
    tensor or the pair (x, h), joined in w's dtype.  Used for CPU tensors
    and as the reference the kernel is held to on the card; eager autograd
    through it is the oracle of every training route."""
    return gate_update(_gates_plain(join_xh(xh, w.dtype), w, b, xg), c)


def fused_cell_gates_plain(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``emit_gates`` mode in plain PyTorch: (h', c', the f32 gates
    rounded to xh's dtype); the state update reads the unrounded gates."""
    gates = _gates_plain(xh, w, b, xg)
    h_new, c_new = gate_update(gates, c)
    return h_new, c_new, gates.to(xh.dtype)


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


def dw_per_tap(x: torch.Tensor, dgates: torch.Tensor, k: int) -> torch.Tensor:
    """f32 weight gradient (k,k,Cin,N) of the SAME k x k conv of x
    (B,H,W,Cin) for the output cotangent dgates (B,H,W,N): one f32 matmul
    per tap, x's shifted window against dgates, operands upcast.  cuDNN's
    f32 weight gradient on an H100 was measured off by 1.6e-2 of its largest
    entry at the training layer-1 shape (B=8, 100x154, 72 -> 256, k=5), and
    this is the dW kernel's reference."""
    p = k // 2
    B, H, W, cin = x.shape
    g2 = dgates.float().reshape(-1, dgates.shape[-1])
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p, p, p))
    return torch.stack([
        xp[:, dy : dy + H, dx : dx + W].reshape(-1, cin).T @ g2
        for dy in range(k) for dx in range(k)
    ]).reshape(k, k, cin, -1)


def check_cell_args(xh, c, w, b, xg=None) -> None:
    """Raise on what the kernel does not take: xh (B,H,W,Cin) and w
    (k,k,Cin,4*hid) of one dtype, bf16 or f32; c (B,H,W,hid) and b (4*hid,)
    f32; xg, when given, (B,H,W,4*hid) in xh's dtype; k odd in 1..7; all
    contiguous and on one device."""
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
    if xg is not None and (tuple(xg.shape) != (B, H, W, 4 * hid)
                           or xg.dtype != xh.dtype):
        raise ValueError(
            f"xg must be {xh.dtype} (B,H,W,4h) = {(B, H, W, 4 * hid)}; got "
            f"{xg.dtype} {tuple(xg.shape)}"
        )
    ts = (xh, c, w, b) if xg is None else (xh, c, w, b, xg)
    if not all(t.device == xh.device for t in ts):
        raise ValueError("xh, c, w, b and xg must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("xh, c, w, b and xg must be contiguous")


def cell_plan(dtype: torch.dtype, B, H, W, cin, hid, k) -> str:
    """Which mainloop of ``csrc/cell_mainloop.cuh`` the cell kernels (every
    B1 mode and B2's gate recompute) take for these shapes, as the library
    plans them (builds the library): ``"wgmma"`` (bf16, hid 8/16/32/64) or
    ``"fp32"`` (the FP32 pipes); raises if no kernel takes them."""
    plan = _build.load_kernels().niswan_cell_plan(
        int(dtype == torch.bfloat16), B, H, W, cin, hid, k)
    if plan < 0:
        raise ValueError(f"no cell kernel for B={B} H={H} W={W} Cin={cin} hid={hid} k={k}")
    return "wgmma" if plan == 1 else "fp32"


@functools.lru_cache(maxsize=None)
def _pack_floats(bf16: bool, cin: int, hid: int, k: int) -> int:
    n = _build.load_kernels().niswan_cell_pack_floats(int(bf16), cin, hid, k)
    if n < 0:
        raise ValueError(f"no cell kernel for Cin {cin}, hid {hid}, k {k}")
    return n


# id(w) -> (w's version, its data pointer, its packed image)
_PACKED = {}
# the packs of the CUDA graph capture under way (``capture_scope``), or None
_SCOPE = None


@contextlib.contextmanager
def capture_scope():
    """While a training step is captured: every weight is packed inside the
    capture, and a pack made there is reused only there.  A pack made
    before (a cache hit on a weight the captured step then updates in
    place) would leave every replay reading step 1's image."""
    global _SCOPE
    outer, _SCOPE = _SCOPE, {}
    try:
        yield
    finally:
        _SCOPE = outer


def packed_weights(w: torch.Tensor) -> Optional[torch.Tensor]:
    """w's packed image for the wgmma mainloop (``pack_cell_weights_kernel``:
    one wgmma B tile per K step, in the order the ring streams them), or
    None where the FP32 pipes take the shapes.  Made once per weight tensor
    and kept while it lives and is unchanged (same version and storage): a
    serving model packs each layer once, the whole-scan BPTT its combined
    kernel once per chunk, for every launch of the forward and the backward.
    An inference tensor has no version counter and counts as unchanged
    while it lives.  Under ``capture_scope`` the cache is the capture's
    own.  The pack runs on the current stream, which later launches
    share."""
    k, _, cin, n4 = w.shape
    n = _pack_floats(w.dtype == torch.bfloat16, cin, n4 // 4, k)
    if not n:
        return None
    cache = _PACKED if _SCOPE is None else _SCOPE
    key, version = id(w), 0 if w.is_inference() else w._version
    hit = cache.get(key)
    if hit is not None and hit[0] == version and hit[1] == w.data_ptr():
        return hit[2]
    out = torch.empty((n,), dtype=torch.float32, device=w.device)
    lib = _build.load_kernels()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.niswan_pack_cell_weights(w.data_ptr(), out.data_ptr(), cin, n4 // 4, k,
                                           stream)
    _raise_on(err, "pack_cell_weights", lib)
    if hit is None:
        weakref.finalize(w, cache.pop, key, None)
    cache[key] = (version, w.data_ptr(), out)
    return out


def _raise_on(err: int, what: str, lib) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.niswan_error_string(err).decode()} (cudaError {err})"
        )


def _launch(xh, c, w, b, xg, emit_gates: bool):
    """One launch of the kernel (xg and the gate output are null unless
    their mode is on); returns (h', c', gates or None).  A launch counts
    once: under ``gates_launches`` with emit_gates (with or without xg),
    else under ``xg_launches`` with xg, else under ``launches``."""
    global launches, gates_launches, xg_launches
    lib = _build.load_kernels()
    fn = (
        lib.niswan_convlstm_cell_bf16
        if xh.dtype == torch.bfloat16
        else lib.niswan_convlstm_cell_f32
    )
    B, H, W, cin = xh.shape
    hid = c.shape[-1]
    wpack = packed_weights(w)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    gates = (
        torch.empty((B, H, W, 4 * hid), dtype=xh.dtype, device=xh.device)
        if emit_gates else None
    )
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = fn(
            xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if xg is None else xg.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(),
            None if gates is None else gates.data_ptr(),
            None if wpack is None else wpack.data_ptr(),
            B, H, W, cin, hid, w.shape[0], stream,
        )
    _raise_on(err, "convlstm_cell", lib)
    if emit_gates:
        gates_launches += 1
    elif xg is not None:
        xg_launches += 1
    else:
        launches += 1
    return h_out, c_out, gates


@torch.library.custom_op(
    "niswan::convlstm_cell", mutates_args=(), device_types="cuda"
)
def _convlstm_cell_cuda(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    h_out, c_out, _ = _launch(xh, c, w, b, None, False)
    return h_out, c_out


@_convlstm_cell_cuda.register_fake
def _(xh, c, w, b):
    return torch.empty_like(c), torch.empty_like(c)


def _part_args(t: torch.Tensor) -> tuple:
    """A part's (data pointer, f32?, strides of b, y, x, c) for the kernel;
    the stride of a dimension of size 1 is given as 0 (it is never used)."""
    return (t.data_ptr(), int(t.dtype == torch.float32),
            *(s if n > 1 else 0 for n, s in zip(t.shape, t.stride())))


def _launch_parts(x, h, c, w, b):
    """One plain launch staging its input from x and h where they lie (bf16
    or f32, any strides), counted under ``launches`` and ``parts_launches``;
    where the library's plan does not take the shapes or the parts'
    layouts, the launch on their concatenation."""
    global launches, parts_launches
    lib = _build.load_kernels()
    B, H, W, cx = x.shape
    hid = c.shape[-1]
    wpack = packed_weights(w)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.niswan_convlstm_cell_parts_bf16(
            *_part_args(x), *_part_args(h), b.data_ptr(), c.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), None if wpack is None else wpack.data_ptr(),
            B, H, W, cx, hid, w.shape[0], stream,
        )
    if err == -1:
        return _launch(join_xh((x, h), w.dtype), c, w, b, None, False)[:2]
    _raise_on(err, "convlstm_cell", lib)
    launches += 1
    parts_launches += 1
    return h_out, c_out


@torch.library.custom_op(
    "niswan::convlstm_cell_parts", mutates_args=(), device_types="cuda"
)
def _convlstm_cell_parts_cuda(
    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_parts(x, h, c, w, b)


@_convlstm_cell_parts_cuda.register_fake
def _(x, h, c, w, b):
    return torch.empty_like(c), torch.empty_like(c)


def _stages_parts(x, h, c, w, b) -> bool:
    """Whether the pair (x, h) goes to the two-part launch: no grad, one
    CUDA device, x and h bf16 or f32 of the shapes ``check_cell_args``
    asks of [x; h], bf16 weights.  Anything else is concatenated (and
    checked) as before; so is what the launch's plan then refuses."""
    ins = (x, h, c, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return False
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        return False
    if {x.dtype, h.dtype} - {torch.bfloat16, torch.float32} or w.dtype != torch.bfloat16 \
            or c.dtype != torch.float32 or b.dtype != torch.float32:
        return False
    if x.dim() != 4 or h.shape != c.shape or x.shape[:3] != c.shape[:3]:
        return False
    cx, hid, k = x.shape[-1], c.shape[-1], w.shape[0]
    return w.shape == (k, k, cx + hid, 4 * hid) and b.shape == (4 * hid,) \
        and all(t.is_contiguous() for t in (c, w, b))


@torch.library.custom_op(
    "niswan::convlstm_cell_gates", mutates_args=(), device_types="cuda"
)
def _convlstm_cell_gates_cuda(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch(xh, c, w, b, xg, True)


@_convlstm_cell_gates_cuda.register_fake
def _(xh, c, w, b, xg):
    return (torch.empty_like(c), torch.empty_like(c),
            xh.new_empty((*xh.shape[:3], w.shape[-1])))


@torch.library.custom_op(
    "niswan::convlstm_cell_xg", mutates_args=(), device_types="cuda"
)
def _convlstm_cell_xg_cuda(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    h_out, c_out, _ = _launch(xh, c, w, b, xg, False)
    return h_out, c_out


@_convlstm_cell_xg_cuda.register_fake
def _(xh, c, w, b, xg):
    return torch.empty_like(c), torch.empty_like(c)


def fused_cell_gates(
    xh: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``emit_gates`` mode (with ``xg`` when given): (h', c' f32, the
    pre-activation gates (B,H,W,4*hid) in xh's dtype).  CPU tensors run the
    plain version, every other device the custom op."""
    check_cell_args(xh, c, w, b, xg)
    if xh.device.type == "cpu":
        return fused_cell_gates_plain(xh, c, w, b, xg)
    return torch.ops.niswan.convlstm_cell_gates(xh, c, w, b, xg)


def _cell_vjp(xh, c, gates, w, dh, dc, need_dx: bool):
    """``_v2_bwd`` / ``_v2_xg_bwd``: (dgates in xh's dtype, dxh f32 or None,
    dc_prev f32, dw f32, db f32) from the kept gates.  dxh is B3 on the
    flipped kernel, dw B2's weight-gradient kernels (plain versions on the
    CPU); dxh is skipped unless ``need_dx``."""
    from nasa_niswan_tpu_torch.ops.convgrad import conv_dw, conv_same, flip_kernel

    dgates32, dc_prev = elementwise_bwd(gates, c, dh, dc)
    dgates = dgates32.to(xh.dtype)
    dxh = conv_same(dgates, flip_kernel(w)) if need_dx else None
    dw = conv_dw(xh, dgates, w.shape[0])
    return dgates, dxh, dc_prev, dw, dgates32.sum(dim=(0, 1, 2))


class FusedCell(torch.autograd.Function):
    """The per-cell custom VJP ``_fused_cell_v2``: the forward keeps (xh, c,
    gates, w), the backward recomputes nothing."""

    @staticmethod
    def forward(ctx, xh, c, w, b):
        h_new, c_new, gates = fused_cell_gates(xh, c, w, b)
        ctx.save_for_backward(xh, c, gates, w)
        return h_new, c_new

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dc):
        xh, c, gates, w = ctx.saved_tensors
        _, dxh, dc_prev, dw, db = _cell_vjp(
            xh, c, gates, w, dh, dc, ctx.needs_input_grad[0]
        )
        return dxh, dc_prev, dw, db


class FusedCellXg(torch.autograd.Function):
    """The per-cell custom VJP ``_fused_cell_v2_xg`` of the hoisted layer 0:
    inputs (xg, h, c, w_h, b); the backward returns dxg = dgates in the
    compute dtype and dw for ``w_h`` only."""

    @staticmethod
    def forward(ctx, xg, h, c, w_h, b):
        h_new, c_new, gates = fused_cell_gates(h, c, w_h, b, xg)
        ctx.save_for_backward(h, c, gates, w_h)
        return h_new, c_new

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dc):
        h, c, gates, w_h = ctx.saved_tensors
        dgates, dh, dc_prev, dw_h, db = _cell_vjp(
            h, c, gates, w_h, dh_out, dc, ctx.needs_input_grad[1]
        )
        return dgates, dh, dc_prev, dw_h, db


def fused_cell_forward(
    xh, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    xg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused cell step; returns (h', c') f32 (B,H,W,hid).  With ``xg``
    (the hoisted input gates, xh's dtype) xh is h alone and w is ``w_h``.

    ``xh`` is one tensor or the pair ``(x, h)`` of its parts, each in any
    dtype and layout.  Without grad on a CUDA device, where the wgmma
    mainloop takes the shape, [x; h] has at most 128 channels and each
    part's layout has a route (a bf16 part with unit channel stride and an
    even channel count, an f32 one with unit channel stride, a
    channels-first bf16 frame), the pair is the two-part launch: the
    kernel stages [x; h] from x and h where they lie (an f32 part rounded
    to bf16 as ``.to(torch.bfloat16)`` rounds), bit-equal to the launch on
    ``join_xh((x, h), w.dtype)``, which is what every other pair is turned
    into.

    When grad is enabled and an input requires it, the step is the per-cell
    autograd Function (``FusedCell`` / ``FusedCellXg``: the emit_gates
    launch, no recompute in the backward).  Otherwise CPU tensors run the
    plain version and every other device the plain or xg launch."""
    if isinstance(xh, tuple):
        x, h = xh
        if xg is None and _stages_parts(x, h, c, w, b):
            return torch.ops.niswan.convlstm_cell_parts(x, h, c, w, b)
        xh = join_xh(xh, w.dtype)
    check_cell_args(xh, c, w, b, xg)
    ins = (xh, c, w, b) if xg is None else (xh, c, w, b, xg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if xg is None:
            return FusedCell.apply(xh, c, w, b)
        return FusedCellXg.apply(xg, xh, c, w, b)
    if xh.device.type == "cpu":
        return fused_cell_forward_plain(xh, c, w, b, xg)
    if xg is None:
        return torch.ops.niswan.convlstm_cell(xh, c, w, b)
    return torch.ops.niswan.convlstm_cell_xg(xh, c, w, b, xg)
