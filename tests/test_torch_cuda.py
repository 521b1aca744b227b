"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: the fused ConvLSTM cell forward (B1) in its plain, emit_gates and xg
modes and its plain mode's two-part launch (bit-equal to the launch on
the concatenated input), the fused cell backward (B2) and its dW kernel
on its own (at every main-path shape, on unaligned operands, its kernel
name and sub-counter), the SAME data-gradient conv (B3), and the two
training routes built on them
(the whole-scan BPTT and the per-cell Functions); the serving loops
replayed as CUDA graphs against their eager bodies; and the UNet's forward
on the card against the CPU, and its 6-channel closed loop as graph
replays against its eager body; parallel/: B1 on halo-extended tiles
against the whole frame, the sharded rollout and closed loop on a one-rank
NCCL group, and (with two cards) two NCCL ranks; training at scale: the
spatially sharded step and the UNet's DP step on a one-rank NCCL group
against the device step, B2, dW and B3 at tile shapes, an async
checkpoint of card tensors, StepTimer's CUDA events, and (with two cards)
the two-rank sharded steps; the port's spans: a serving replay's device
time under a profiler, and the kernels' load counted.

Needs an NVIDIA GPU and nvcc; every test here skips without a CUDA device.
On a machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which the port
does not need.)  This file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import (  # noqa: E402
    ConvLSTMConfig,
    convlstm_apply,
    convlstm_init,
)
from nasa_niswan_tpu_torch.ops import convgrad, convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.ops.convgrad import (  # noqa: E402
    cell_grads,
    cell_grads_plain,
    conv_dw,
    conv_same,
    conv_same_plain,
    fused_cell_bwd,
    fused_cell_bwd_plain,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    dw_per_tap,
    fused_cell_forward,
    fused_cell_forward_plain,
    fused_cell_gates,
    fused_cell_gates_plain,
    join_xh,
)
from nasa_niswan_tpu_torch.rollout.autoregressive import (  # noqa: E402
    make_rollout_fn,
    make_streaming_rollout,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cell_inputs(device, dtype, B, H, W, cin, hid, k, seed=0):
    rng = np.random.default_rng(seed)
    xh = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((B, H, W, hid)), dtype=torch.float32)
    w = torch.tensor(
        rng.standard_normal((k, k, cin, 4 * hid)) / np.sqrt(k * k * cin),
        dtype=torch.float32,
    )
    b = torch.tensor(0.1 * rng.standard_normal(4 * hid), dtype=torch.float32)
    return xh.to(device, dtype), c.to(device), w.to(device, dtype), b.to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,H,W,cin,hid,k",
    [
        (1, 16, 24, 9, 8, 3),
        (2, 20, 28, 13, 16, 5),
        (1, 10, 12, 5, 4, 1),
        (1, 9, 37, 70, 64, 7),  # two channel chunks, ragged rows and columns
    ],
)
def test_kernel_matches_plain(device, dtype, B, H, W, cin, hid, k):
    """f32 sums in another order: tolerance 1e-3, and reruns bit-identical."""
    args = _cell_inputs(device, dtype, B, H, W, cin, hid, k)
    before = convlstm_cell.launches
    h1, c1 = fused_cell_forward(*args)
    h1b, c1b = fused_cell_forward(*args)
    h2, c2 = fused_cell_forward_plain(*args)
    torch.cuda.synchronize()
    assert convlstm_cell.launches == before + 2
    assert torch.equal(h1, h1b) and torch.equal(c1, c1b)
    assert (h1 - h2).abs().max().item() <= 1e-3
    assert (c1 - c2).abs().max().item() <= 1e-3


MODE_SHAPES = [
    (1, 16, 24, 9, 8, 3),
    (2, 20, 28, 13, 16, 5),
    (1, 10, 12, 5, 4, 1),
    (1, 9, 37, 70, 64, 7),
    (2, 12, 20, 64, 64, 5),  # the hoisted layer 0: Cin = hid
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,cin,hid,k", MODE_SHAPES)
@pytest.mark.parametrize("with_xg", [False, True])
def test_modes_match_plain(device, dtype, B, H, W, cin, hid, k, with_xg):
    """emit_gates (with and without xg) and the xg-only launch against
    their plain versions: h', c' within 1e-3 (f32 sums in another order),
    the gates within one bf16 step (2**-7 relative) plus 1e-5 in bf16, 1e-5
    in f32; reruns bit-identical; each launch counted once."""
    xh, c, w, b = _cell_inputs(device, dtype, B, H, W, cin, hid, k)
    xg = None
    if with_xg:
        rng = np.random.default_rng(5)
        xg = torch.tensor(rng.standard_normal((B, H, W, 4 * hid)),
                          dtype=torch.float32).to(device, dtype)
    before = (convlstm_cell.gates_launches, convlstm_cell.xg_launches,
              convlstm_cell.launches)
    got, again = fused_cell_gates(xh, c, w, b, xg), fused_cell_gates(xh, c, w, b, xg)
    want = fused_cell_gates_plain(xh, c, w, b, xg)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert got[2].dtype == dtype and got[2].shape == (B, H, W, 4 * hid)
    assert (got[0] - want[0]).abs().max().item() <= 1e-3
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got[2].float(), want[2].float(), rtol=rtol, atol=1e-5)
    if with_xg:
        h1, c1 = fused_cell_forward(xh, c, w, b, xg)
        torch.cuda.synchronize()
        assert torch.equal(h1, got[0]) and torch.equal(c1, got[1])
    after = (convlstm_cell.gates_launches, convlstm_cell.xg_launches,
             convlstm_cell.launches)
    # a launch counts once: with emit_gates under gates_launches, xg alone
    # under xg_launches
    assert [a - b_ for a, b_ in zip(after, before)] == [2, 1 if with_xg else 0, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,cin,n,k", [(1, 16, 24, 9, 32, 3), (2, 12, 20, 72, 256, 5),
                                           (2, 12, 20, 64, 256, 5), (1, 10, 12, 5, 16, 1)])
def test_conv_dw_matches_plain(device, dtype, B, H, W, cin, n, k):
    """B2's dW kernels on their own against one f32 matmul per tap, within
    1e-3 of the largest entry; reruns bit-identical."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((B, H, W, n)), dtype=torch.float32)
    x, g = x.to(device, dtype), g.to(device, dtype)
    before = convgrad.dw_launches
    got, again = conv_dw(x, g, k), conv_dw(x, g, k)
    want = dw_per_tap(x, g, k)
    torch.cuda.synchronize()
    assert convgrad.dw_launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (k, k, cin, n)
    assert torch.equal(got, again)
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("cin", [6, 70, 126])
def test_conv_dw_bf16_ragged_cin_on_the_tensor_cores(device, cin):
    """bf16 dW at channel counts that are not multiples of 8 (config #3's
    layer 1 takes 70, the 20-level fusion 126) takes the tensor-core plan and
    holds the per-tap f32 matmul within 1e-3 of the largest entry; reruns
    bit-identical.  Also through a 2-byte-misaligned xh (a padded copy)."""
    B, H, W, n, k = 2, 13, 21, 256, 5
    assert convgrad.dw_plan(torch.bfloat16, B, H, W, cin, n, k) == "wgmma"
    assert convgrad.dw_plan(torch.float32, B, H, W, cin, n, k) == "fp32"
    rng = np.random.default_rng(cin)
    x = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((B, H, W, n)), dtype=torch.bfloat16)
    x, g = x.to(device), g.to(device)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    x_odd = flat[1:].view(x.shape)
    x_odd.copy_(x)
    got, again, odd = conv_dw(x, g, k), conv_dw(x, g, k), conv_dw(x_odd, g, k)
    want = dw_per_tap(x, g, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, odd)
    assert _rel(got, want) <= 1e-3


# (B, H, W, Cin, N, k) of every dW launch shape of the main paths (as
# chip_smoke.DW_SHAPES): the three training layers, config #3's layer 1
# (Cin 70), the hoisted layer 0's h-conv, the hoisted input conv over all
# T*B frames; and config #2's layer 1 (Cin 126)
DW_SHAPES = ((8, 100, 154, 72, 256, 5), (8, 100, 154, 96, 128, 3), (8, 100, 154, 48, 64, 3),
             (8, 100, 154, 70, 256, 5), (8, 100, 154, 64, 256, 5), (384, 100, 154, 8, 256, 5),
             (8, 100, 154, 126, 256, 5))


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_conv_dw_wgmma_at_the_main_path_shapes(device, shape):
    """B2's dW alone at every main-path dW shape, bf16: planned on the
    wgmma kernel, within 1e-3 of the largest entry of the per-tap f32
    matmul, reruns bit-identical, each launch counted once under
    ``dw_launches`` and once under ``dw_wgmma_launches``."""
    B, H, W, cin, n, k = shape
    assert convgrad.dw_plan(torch.bfloat16, *shape) == "wgmma"
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    g = torch.randn((B, H, W, n), generator=gen, device=device).bfloat16()
    before = (convgrad.dw_launches, convgrad.dw_wgmma_launches)
    got, again = conv_dw(x, g, k), conv_dw(x, g, k)
    assert (convgrad.dw_launches, convgrad.dw_wgmma_launches) == (before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    del again
    assert _rel(got, dw_per_tap(x, g, k)) <= 1e-3


@pytest.mark.parametrize("cin,n,k", [(8, 256, 5), (70, 40, 3), (126, 256, 7), (5, 16, 1)])
def test_conv_dw_wgmma_unaligned_operands(device, cin, n, k):
    """dW through a 2-byte-misaligned xh and dgates (no tensor map takes
    them, so both are copied into zero-padded, aligned buffers first), at
    channel and column counts that are not multiples of 8: bit-equal to
    the launch on the aligned tensors, within 1e-3 of the per-tap f32
    matmul."""
    B, H, W = 2, 19, 35
    rng = np.random.default_rng(cin + n)
    x = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.bfloat16).to(device)
    g = torch.tensor(rng.standard_normal((B, H, W, n)), dtype=torch.bfloat16).to(device)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    got, shifted = conv_dw(x, g, k), conv_dw(odd(x), odd(g), k)
    torch.cuda.synchronize()
    assert torch.equal(got, shifted)
    assert _rel(got, dw_per_tap(x, g, k)) <= 1e-3


def test_dw_kernel_name_and_launch_counts(device):
    """Under ``torch.profiler`` one ``conv_dw`` and one B2 launch each run
    exactly one kernel whose demangled name holds ``dw_mma_kernel`` (the
    benchmark's kernel class ``dw`` finds dW by that name and counts one
    per ``dw_launches`` and ``cell_bwd_launches``), and each adds one to
    ``dw_wgmma_launches``."""
    from torch.profiler import ProfilerActivity, profile

    B, H, W, cin, hid, k = 2, 12, 20, 72, 64, 5
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, B, H, W, cin, hid, k)
    rng = np.random.default_rng(11)
    dh, dc = (torch.tensor(rng.standard_normal(c.shape), dtype=torch.float32, device=device)
              for _ in range(2))
    g = torch.tensor(rng.standard_normal((B, H, W, 4 * hid)), dtype=torch.bfloat16).to(device)
    conv_dw(xh, g, k)
    fused_cell_bwd(xh, c, dh, dc, w, b)  # the library is built and loaded
    torch.cuda.synchronize()
    counts = lambda: (convgrad.dw_launches, convgrad.cell_bwd_launches,  # noqa: E731
                      convgrad.dw_wgmma_launches)
    before = counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        conv_dw(xh, g, k)
        fused_cell_bwd(xh, c, dh, dc, w, b)
        torch.cuda.synchronize()
    assert [a - b_ for a, b_ in zip(counts(), before)] == [1, 1, 2]
    names = [e.name for e in prof.events() if "dw_mma_kernel" in e.name]
    assert len(names) == 2 and all("dw_mma_kernel_wgmma" in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_xg", [False, True])
def test_fused_cell_grads_match_autograd(device, dtype, with_xg):
    """The per-cell Functions (FusedCell, FusedCellXg) on the kernels against
    eager autograd through the plain cell, relative to each gradient's
    largest entry: 1e-4 in f32; 2e-2 in bf16, where the Function rounds the
    kept gates and dgates to bf16 and eager autograd does not."""
    B, H, W, cin, hid, k = 2, 12, 20, 24, 16, 5
    xh, c, w, b = _cell_inputs(device, dtype, B, H, W, cin, hid, k)
    rng = np.random.default_rng(7)
    xg = torch.tensor(rng.standard_normal((B, H, W, 4 * hid)), dtype=torch.float32
                      ).to(device, dtype) if with_xg else None
    dh, dc = (torch.tensor(rng.standard_normal(c.shape), dtype=torch.float32,
                           device=device) for _ in range(2))

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (xh, c, w, b)]
        extra = [] if xg is None else [xg.clone().requires_grad_(True)]
        out = fn(*ins, *extra)
        return torch.autograd.grad(out, ins + extra, (dh, dc))

    before = (convlstm_cell.gates_launches, convgrad.conv_same_launches,
              convgrad.dw_launches)
    got = grads(fused_cell_forward)
    after = (convlstm_cell.gates_launches, convgrad.conv_same_launches,
             convgrad.dw_launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1]
    want = grads(fused_cell_forward_plain)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and _rel(g, p) <= tol


def test_taps_differentiate_on_the_card(device):
    """Per-step taps and a ``tap_fn`` under grad run the per-cell route on
    the kernels (no autograd formula is needed for the plain launch) and
    match eager autograd through the plain cell, f32, 1e-4 of each leaf's
    largest gradient entry."""
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=(16, 8), kernel_sizes=(5, 3))
    params = convlstm_init(torch.Generator().manual_seed(1), cfg, device=device)
    leaves = [t.requires_grad_(True) for cell in params["cells"] for t in cell.values()]
    x = torch.tensor(np.random.default_rng(8).standard_normal((2, 4, 12, 20, 6)),
                     dtype=torch.float32, device=device)

    def grads(**kw):
        _, taps = convlstm_apply(params, x, cfg, return_per_step=True, **kw)
        _, taps2 = convlstm_apply(params, x, cfg, return_per_step=True,
                                  tap_fn=lambda h: h.square().mean(-1), **kw)
        return torch.autograd.grad((taps**2).sum() + taps2.sum(), leaves)

    before = convlstm_cell.gates_launches
    got = grads()
    assert convlstm_cell.gates_launches == before + 2 * 2 * 4
    want = grads(cell_fn=fused_cell_forward_plain)
    for g, p in zip(got, want):
        assert _rel(g, p) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_hoisted_route_matches_eager_on_the_card(device, dtype, tol):
    """``precompute_input_conv`` under grad: the hoisted conv (B3, its
    gradients from B3 and B2's dW kernels) and layer 0 in the xg mode,
    against eager autograd through the plain cell without cuDNN, relative
    to each leaf's largest gradient entry."""
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=(16, 8), kernel_sizes=(5, 3),
                         compute_dtype=dtype)
    params = convlstm_init(torch.Generator().manual_seed(2), cfg, device=device)
    leaves = [t.requires_grad_(True) for cell in params["cells"] for t in cell.values()]
    x = torch.tensor(np.random.default_rng(9).standard_normal((2, 4, 12, 20, 6)),
                     dtype=torch.float32, device=device)

    def grads(**kw):
        pred = convlstm_apply(params, x, cfg, precompute_input_conv=True, **kw)
        return torch.autograd.grad((pred**2).sum(), leaves)

    counts = lambda: (convlstm_cell.gates_launches, convlstm_cell.xg_launches,  # noqa: E731
                      convgrad.dw_launches)
    before = counts()
    got = grads()
    # 4 steps x 2 layers of emit_gates (layer 0's with xg too, counted once),
    # and one more dW launch for the hoisted conv
    assert [a - b_ for a, b_ in zip(counts(), before)] == [8, 0, 9]
    with torch.backends.cudnn.flags(enabled=False):
        want = grads(cell_fn=fused_cell_forward_plain, grads_fn=None)
    for g, p in zip(got, want):
        assert _rel(g, p) <= tol


def test_kernel_rejects_bad_args(device):
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, 1, 8, 8, 4, 4, 3)
    with pytest.raises(ValueError):
        fused_cell_forward(xh.transpose(1, 2), c, w, b)
    with pytest.raises(TypeError):
        fused_cell_forward(xh, c, w.float(), b)


def test_rollout_kernel_matches_plain(device):
    cfg = ConvLSTMConfig(
        in_channels=8, hidden_channels=(8, 4, 4), kernel_sizes=(5, 3, 3)
    )
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    norm = Normalizer(np.zeros(8, np.float32), np.ones(8, np.float32), 0.5, 2.0)
    forcings = np.random.default_rng(1).standard_normal((2, 6, 8, 16, 24))
    kw = dict(padded_shape=(20, 28), grid_shape=(16, 24), device=device)
    rollout = make_rollout_fn(cfg, norm, **kw)
    rollout(params, forcings.astype(np.float32))  # warm-up and capture
    before = convlstm_cell.launches
    p1, s1 = rollout(params, forcings.astype(np.float32))  # one replay
    assert convlstm_cell.launches == before + 3 * 6
    p2, s2 = make_rollout_fn(cfg, norm, cell_fn=fused_cell_forward_plain, **kw)(
        params, forcings.astype(np.float32)
    )
    assert (p1 - p2).abs().max().item() <= 1e-4
    for (h1, c1), (h2, c2) in zip(s1, s2):
        assert (h1 - h2).abs().max().item() <= 1e-4
        assert (c1 - c2).abs().max().item() <= 1e-4


# hid 4 runs the gate recompute on the FP32 pipes in bf16 too; 8, 16, 32
# and 64 on the tensor cores.  dW runs on the tensor cores for every bf16
# shape (a ragged Cin through a zero-padded copy of xh), on the FP32 pipes
# for f32.
BWD_SHAPES = [
    (1, 16, 24, 9, 8, 3),
    (2, 20, 28, 13, 16, 5),
    (1, 10, 12, 5, 4, 1),
    (1, 10, 12, 8, 4, 1),
    (1, 9, 37, 70, 64, 7),  # two channel chunks, ragged rows and columns
    (1, 11, 19, 48, 16, 7),  # a ragged last pass of pixels
    (2, 20, 28, 96, 32, 3),
    (2, 12, 20, 72, 64, 5),  # the training layer-1 widths
]


def _rel(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,cin,hid,k", BWD_SHAPES)
def test_cell_bwd_matches_plain(device, dtype, B, H, W, cin, hid, k):
    """B2 against its plain version.  f32 sums in another order; in bf16 a
    gate cotangent may round to the neighbouring bf16 value, so dgates is
    held to one bf16 step (at most 2**-7 relative) and dw to 1e-3 of its
    largest entry.  Reruns bit-identical."""
    xh, c, w, b = _cell_inputs(device, dtype, B, H, W, cin, hid, k)
    rng = np.random.default_rng(1)
    dh, dc = (torch.tensor(rng.standard_normal(c.shape), dtype=torch.float32,
                           device=device) for _ in range(2))
    before = convgrad.cell_bwd_launches
    got = fused_cell_bwd(xh, c, dh, dc, w, b)
    again = fused_cell_bwd(xh, c, dh, dc, w, b)
    want = fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    torch.cuda.synchronize()
    assert convgrad.cell_bwd_launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    dg, dcp, dw, db = got
    assert dg.dtype == dtype and dw.dtype == db.dtype == dcp.dtype == torch.float32
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dg.float(), want[0].float(), rtol=rtol, atol=1e-5)
    torch.testing.assert_close(dcp, want[1], rtol=1e-5, atol=1e-5)
    assert _rel(dw, want[2]) <= 1e-3
    assert _rel(db, want[3]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,H,W,cin,cout,k",
    [(1, 16, 24, 32, 9, 3), (2, 20, 28, 64, 13, 5), (1, 10, 12, 16, 5, 1),
     (1, 9, 37, 256, 126, 7), (2, 12, 20, 256, 72, 5), (1, 13, 21, 128, 96, 3),
     (2, 9, 17, 64, 48, 3),
     # config #3's layer 1 (Cout 70), the 20-level fusion's (126), and the
     # hoisted conv of C = 62 frames (a ragged Cin, padded by the wrapper)
     (2, 12, 20, 256, 70, 5), (1, 11, 35, 256, 126, 5), (2, 10, 18, 62, 256, 5)],
)
def test_conv_same_matches_plain(device, dtype, B, H, W, cin, cout, k):
    """B3 against an f32 conv of the same operands: f32 sums in another
    order over K <= 12,544 terms of O(1/sqrt(K)); reruns bit-identical."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin),
                     dtype=torch.float32)
    x, w = x.to(device, dtype), w.to(device, dtype)
    before = convgrad.conv_same_launches
    got, again = conv_same(x, w), conv_same(x, w)
    want = conv_same_plain(x, w)
    torch.cuda.synchronize()
    assert convgrad.conv_same_launches == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


def test_conv_same_misaligned_operands(device):
    """bf16 operands that start 2 bytes off a 16-byte boundary are copied
    once by the wrapper: the result equals that of the aligned operands."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 12, 20, 64)), dtype=torch.bfloat16).to(device)
    w = torch.tensor(rng.standard_normal((3, 3, 64, 72)) / 24.0,
                     dtype=torch.bfloat16).to(device)
    odd = []
    for t in (x, w):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        odd.append(flat[1:].view(t.shape))
        odd[-1].copy_(t)
    assert odd[0].data_ptr() % 16 and odd[1].data_ptr() % 16
    assert torch.equal(conv_same(*odd), conv_same(x, w))


def test_cell_grads_matches_plain(device):
    """B2 then B3 against the plain per-cell backward, f32."""
    xh, c, w, b = _cell_inputs(device, torch.float32, 2, 12, 20, 24, 16, 3)
    dh = torch.ones_like(c)
    dc = 0.5 * torch.ones_like(c)
    for g, p in zip(cell_grads(xh, c, dh, dc, w, b),
                    cell_grads_plain(xh, c, dh, dc, w, b)):
        assert _rel(g, p) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bptt_kernel_path_matches_eager_autograd(device, dtype):
    """Gradients of a small model through the whole-scan BPTT on the kernels
    against eager autograd through the plain cell, per parameter leaf,
    relative to the leaf's largest entry: 1e-4 in f32; 2e-2 in bf16, where
    the two paths round dgates, dw and dxh to bf16 at different places."""
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=(16, 8),
                         kernel_sizes=(5, 3), compute_dtype=dtype, remat=True)
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    for t in [t for cell in params["cells"] for t in cell.values()] + list(
            params["head"].values()):
        t.requires_grad_(True)
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 4, 12, 20, 6)),
                     dtype=torch.float32, device=device)
    leaves = [t for cell in params["cells"] for t in cell.values()]
    leaves += list(params["head"].values())

    def grads(**kw):
        pred = convlstm_apply(params, x, cfg, **kw)
        return torch.autograd.grad((pred**2).sum(), leaves)

    before = (convlstm_cell.launches, convgrad.cell_bwd_launches,
              convgrad.conv_same_launches)
    got = grads()
    after = (convlstm_cell.launches, convgrad.cell_bwd_launches,
             convgrad.conv_same_launches)
    assert [a - b for a, b in zip(after, before)] == [2 * 4] * 3
    want = grads(cell_fn=fused_cell_forward_plain, grads_fn=None)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, p in zip(got, want):
        assert _rel(g, p) <= tol


# ---- the wgmma mainloop at the main-path shapes ------------------------------

# (H, W, Cin, hid, k) of every layer shape of B1 and B2 on the main paths:
# serving layer 1 (Cin 126), training layer 1 (72), config #3's layer 1
# (70), the hoisted layer 0's h-conv (64), layers 2 and 3
LAYER_SHAPES = [(100, 154, 126, 64, 5), (100, 154, 72, 64, 5), (100, 154, 70, 64, 5),
                (100, 154, 64, 64, 5), (100, 154, 96, 32, 3), (100, 154, 48, 16, 3)]
# each at B = 1 and 8, then the ragged check shapes of chip_smoke.py
MAIN_SHAPES = [(B, *s) for B in (1, 8) for s in LAYER_SHAPES] + [
    (2, 20, 28, 13, 16, 5), (2, 37, 45, 126, 64, 5)]


def test_cell_plan_puts_bf16_main_path_shapes_on_wgmma(device):
    """The library's plan: every bf16 shape above on the wgmma mainloop,
    f32 and bf16 at a hid outside 8/16/32/64 on the FP32 pipes, and no
    kernel for an even k."""
    for shape in MAIN_SHAPES:
        assert convlstm_cell.cell_plan(torch.bfloat16, *shape) == "wgmma", shape
        assert convlstm_cell.cell_plan(torch.float32, *shape) == "fp32", shape
    assert convlstm_cell.cell_plan(torch.bfloat16, 1, 10, 12, 5, 4, 1) == "fp32"
    assert convlstm_cell.cell_plan(torch.bfloat16, 1, 10, 12, 5, 128, 3) == "fp32"
    with pytest.raises(ValueError):
        convlstm_cell.cell_plan(torch.bfloat16, 1, 10, 12, 5, 8, 4)


# the modes at the shapes where the main paths run them: the plain mode and
# emit_gates at every shape, xg (serving) and xg with emit_gates (training)
# where Cin = hid, the hoisted layer 0's h-conv
MODE_CASES = [(mode, shape) for shape in MAIN_SHAPES for mode in ("plain", "gates", "xg", "gates+xg")
              if "xg" not in mode or shape[3] == shape[4]]


@pytest.mark.parametrize("mode,shape", MODE_CASES)
def test_wgmma_cell_modes_at_main_path_shapes(device, mode, shape):
    """B1 in each mode, bf16, against its plain version: h', c' within 1e-3
    (f32 sums in another order over K <= 3,150 terms), the gates within one
    bf16 step plus 1e-5; reruns bit-identical."""
    B, H, W, cin, hid, k = shape
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, B, H, W, cin, hid, k, seed=B + cin)
    xg = None
    if "xg" in mode:
        rng = np.random.default_rng(6)
        xg = torch.tensor(rng.standard_normal((B, H, W, 4 * hid)),
                          dtype=torch.float32).to(device, torch.bfloat16)
    if mode.startswith("gates"):
        fn, plain = fused_cell_gates, fused_cell_gates_plain
    else:
        fn, plain = fused_cell_forward, fused_cell_forward_plain
    got, again, want = fn(xh, c, w, b, xg), fn(xh, c, w, b, xg), plain(xh, c, w, b, xg)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert (got[0] - want[0]).abs().max().item() <= 1e-3
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    if mode.startswith("gates"):
        torch.testing.assert_close(got[2].float(), want[2].float(), rtol=2.0**-7, atol=1e-5)


@pytest.mark.parametrize("B,H,W,cin,hid,k", MAIN_SHAPES)
def test_wgmma_cell_bwd_at_main_path_shapes(device, B, H, W, cin, hid, k):
    """B2, bf16, against its plain version with the bounds of
    test_cell_bwd_matches_plain; its gate recompute alone
    (``cell_bwd_recompute``) gives B2's dgates, dc_prev and db bit for bit;
    reruns bit-identical."""
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, B, H, W, cin, hid, k, seed=B + cin)
    rng = np.random.default_rng(1)
    dh, dc = (torch.tensor(rng.standard_normal(c.shape), dtype=torch.float32,
                           device=device) for _ in range(2))
    got = fused_cell_bwd(xh, c, dh, dc, w, b)
    again = fused_cell_bwd(xh, c, dh, dc, w, b)
    alone = convgrad.cell_bwd_recompute(xh, c, dh, dc, w, b)
    want = fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, a in zip((got[0], got[1], got[3]), alone):
        assert torch.equal(g, a)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2.0**-7, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert _rel(got[2], want[2]) <= 1e-3
    assert _rel(got[3], want[3]) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("route", ["remat", "per-cell", "hoisted"])
def test_training_routes_match_eager_at_t8(device, route, dtype, tol):
    """The T = 8 parameter gradients of each training route (whole-scan
    BPTT, per-cell Functions, hoisted input conv) at the canonical widths
    (8 inputs, hidden 64/32/16, kernels 5/3/3) against eager autograd
    through the plain cell without cuDNN, per leaf relative to its norm:
    chip_smoke.py's TOL_GRAD."""
    cfg = ConvLSTMConfig(in_channels=8, hidden_channels=(64, 32, 16), kernel_sizes=(5, 3, 3),
                         compute_dtype=dtype, remat=route == "remat")
    params = convlstm_init(torch.Generator().manual_seed(4), cfg, device=device)
    leaves = [t.requires_grad_(True) for cell in params["cells"] for t in cell.values()]
    x = torch.tensor(np.random.default_rng(10).standard_normal((2, 8, 40, 56, 8)),
                     dtype=torch.float32, device=device)
    hoist = dict(precompute_input_conv=True) if route == "hoisted" else {}

    def grads(**kw):
        pred = convlstm_apply(params, x, cfg, **hoist, **kw)
        return torch.autograd.grad((pred**2).sum(), leaves)

    got = grads()
    with torch.backends.cudnn.flags(enabled=False):
        want = grads(cell_fn=fused_cell_forward_plain, grads_fn=None)
    for g, p in zip(got, want):
        assert ((g - p).norm() / p.norm()).item() <= tol


def test_packed_weights_follow_the_weight_tensor(device):
    """The wgmma mainloop's packed weights are made once per weight tensor
    and reused while it is unchanged; an in-place update packs anew, and
    the cell then computes with the new weights."""
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, 1, 12, 20, 24, 16, 3)
    packed = convlstm_cell.packed_weights(w)
    assert convlstm_cell.packed_weights(w) is packed
    h1, _ = fused_cell_forward(xh, c, w, b)
    w.mul_(0.5)
    assert convlstm_cell.packed_weights(w) is not packed
    h2, _ = fused_cell_forward(xh, c, w, b)
    want, _ = fused_cell_forward_plain(xh, c, w, b)
    assert not torch.equal(h1, h2)
    assert (h2 - want).abs().max().item() <= 1e-3
    assert convlstm_cell.packed_weights(w.float()) is None


def test_packed_weights_of_inference_tensors(device):
    """Weights made under inference mode (no version counter), as serving
    makes them, are packed once and used as they are."""
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, 1, 12, 20, 24, 16, 3)
    with torch.inference_mode():
        wi = w.clone()
        packed = convlstm_cell.packed_weights(wi)
        assert convlstm_cell.packed_weights(wi) is packed
        h, _ = fused_cell_forward(xh, c, wi, b)
    want, _ = fused_cell_forward_plain(xh, c, w, b)
    assert (h - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("cin", [70, 126, 72])
def test_cell_halo_at_every_xh_alignment(device, cin):
    """xh starting 2, 4, 8 or 12 bytes off a 16-byte boundary (element-wise,
    4-byte raw-run and 16-byte halo copies) gives the aligned result bit
    for bit, in the plain mode and in B2."""
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, 1, 20, 37, cin, 64, 5)
    dh = torch.ones_like(c)
    want = fused_cell_forward(xh, c, w, b)
    want_bwd = fused_cell_bwd(xh, c, dh, dh, w, b)
    for shift in (1, 2, 4, 6):
        flat = torch.empty(xh.numel() + 8, dtype=xh.dtype, device=device)
        odd = flat[shift : shift + xh.numel()].view(xh.shape)
        odd.copy_(xh)
        assert odd.data_ptr() % 16 == 2 * shift
        for g, a in zip(fused_cell_forward(odd, c, w, b), want):
            assert torch.equal(g, a), shift
        for g, a in zip(fused_cell_bwd(odd, c, dh, dh, w, b), want_bwd):
            assert torch.equal(g, a), shift


# ---- B1 reading its input [x; h] from two tensors where they lie -----------

# (B, x's layout, Cx, hid, k) on the 100 x 154 frame: serving layers 1-3
# (B 1; layer 1's x a step of a prepared chunk, channel stride H*W),
# training layers 1-3 (B 8; layer 1's x a step of the NHWC batch) and
# config #3's layer 1 (Cin 70); h is the f32 carry.  Their routes (planes,
# f32 scratch, registers, direct copies) are tests/test_torch_cell_tiles.py's
PART_SHAPES = {
    "serve-62+64": (1, "frame", 62, 64, 5),
    "serve-64+32": (1, "f32", 64, 32, 3),
    "serve-32+16": (1, "f32", 32, 16, 3),
    "train-8+64": (8, "xs", 8, 64, 5),
    "train-64+32": (8, "f32", 64, 32, 3),
    "train-32+16": (8, "f32", 32, 16, 3),
    "config3-6+64": (8, "bf16", 6, 64, 5),
}


def _part(kind, B, H, W, C, device, seed):
    """"frame": step 1 of a (B, 3, C, H, W) bf16 chunk moved channels-last,
    as ``_prep_frame`` leaves it ("frame32" the same in f32); "xs": step 1
    of a (B, 3, H, W, C) bf16 batch; "f32" / "bf16": a contiguous (B, H, W,
    C) tensor."""
    g = torch.Generator().manual_seed(seed)
    if kind in ("frame", "frame32"):
        dt = torch.bfloat16 if kind == "frame" else torch.float32
        return torch.randn((B, 3, C, H, W), generator=g).to(device, dt).movedim(2, -1)[:, 1]
    if kind == "xs":
        return torch.randn((B, 3, H, W, C), generator=g).to(device, torch.bfloat16)[:, 1]
    t = torch.randn((B, H, W, C), generator=g).to(device)
    return t if kind == "f32" else t.bfloat16()


def _cat(x, h, dtype=torch.bfloat16):
    return torch.cat([x.to(dtype), h.to(dtype)], dim=-1)


@pytest.mark.parametrize("case", list(PART_SHAPES))
def test_two_part_launch_is_bit_equal_to_the_concatenated_launch(device, case):
    """The pair (x, h) at every main-path shape: one two-part launch,
    counted under ``launches`` and ``parts_launches``, and h', c' bit-equal
    to the launch on the concatenated, cast xh."""
    B, xk, cx, hid, k = PART_SHAPES[case]
    H, W = 100, 154
    _, c, w, b = _cell_inputs(device, torch.bfloat16, B, H, W, cx + hid, hid, k, seed=B + cx)
    x, h = _part(xk, B, H, W, cx, device, 1), _part("f32", B, H, W, hid, device, 2)
    before = (convlstm_cell.launches, convlstm_cell.parts_launches)
    got = fused_cell_forward((x, h), c, w, b)
    assert (convlstm_cell.launches, convlstm_cell.parts_launches) == (before[0] + 1, before[1] + 1)
    want = fused_cell_forward(_cat(x, h), c, w, b)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.parametrize("dtype,xk,cx,hid,grad", [(torch.bfloat16, "frame", 6, 4, False),
                                                  (torch.float32, "frame", 6, 16, False),
                                                  (torch.bfloat16, "frame", 6, 16, True),
                                                  (torch.bfloat16, "frame", 100, 64, False),
                                                  (torch.bfloat16, "frame32", 6, 16, False),
                                                  (torch.bfloat16, "bf16", 13, 16, False)])
def test_a_pair_off_the_two_part_launch_is_concatenated(device, dtype, xk, cx, hid, grad):
    """A pair that the two-part launch does not take (a shape on the FP32
    pipes, f32 weights, grad, 100 + 64 channels, over one 128-channel
    group, or a part whose layout the library's plan refuses: an f32
    channels-first frame, a bf16 x of odd channels) is concatenated and
    cast first: the same h', c' as the concatenated call, one launch under
    ``launches`` and nothing added to ``parts_launches``."""
    B, H, W, k = 1, 16, 24, 3
    _, c, w, b = _cell_inputs(device, dtype, B, H, W, cx + hid, hid, k)
    x, h = _part(xk, B, H, W, cx, device, 3), _part("f32", B, H, W, hid, device, 4)
    w.requires_grad_(grad)
    parts, plain = convlstm_cell.parts_launches, convlstm_cell.launches
    got = fused_cell_forward((x, h), c, w, b)
    assert convlstm_cell.launches - plain == (0 if grad else 1)
    want = fused_cell_forward(_cat(x, h, dtype), c, w, b)
    torch.cuda.synchronize()
    assert convlstm_cell.parts_launches == parts
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_serving_chunk_of_two_part_cells(device):
    """A config #2-shaped chunk (C 62, hidden 64/32/16, kernels 5/3/3,
    bf16, 6 steps): the replay bit-equal to its eager body and to the eager
    body with every cell handed the pair joined by ``join_xh``; a replay adds 3 x 6 to
    ``launches`` and to ``parts_launches``, nothing to the other modes; and
    under ``torch.profiler`` the replay's ``cell_wgmma_kernel`` launches
    with the ``CellEpi`` epilogue are launches + gates_launches +
    xg_launches, as the benchmark's trace check counts them."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ConvLSTMConfig(compute_dtype="bfloat16", in_channels=62,
                         hidden_channels=(64, 32, 16), kernel_sizes=(5, 3, 3))
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)
    norm = Normalizer(rng.standard_normal(62).astype(np.float32),
                      (1.0 + rng.random(62)).astype(np.float32), 0.5, 2.0)
    forcings = torch.tensor(rng.standard_normal((1, 6, 62, 16, 24)), dtype=torch.float32,
                            device=device)
    rollout = make_rollout_fn(cfg, norm, device=device, **G_GEO)
    concatenated = make_rollout_fn(
        cfg, norm, device=device,
        cell_fn=lambda xh, c, w, b, xg=None: fused_cell_forward(join_xh(xh, w.dtype), c, w, b, xg),
        **G_GEO)
    rollout(params, forcings)  # a one-step warm-up, the capture, one replay
    counts = lambda: (convlstm_cell.launches, convlstm_cell.parts_launches,  # noqa: E731
                      convlstm_cell.gates_launches, convlstm_cell.xg_launches)
    before = counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p_g, s_g = rollout(params, forcings)
        torch.cuda.synchronize()
    got = [a - b for a, b in zip(counts(), before)]
    assert got == [3 * 6, 3 * 6, 0, 0]
    cells = [e for e in prof.events()
             if "cell_wgmma_kernel" in e.name and "CellEpi" in e.name]
    assert len(cells) == got[0] + got[2] + got[3]
    p_e, s_e = rollout.eager(params, forcings)
    p_c, s_c = concatenated.eager(params, forcings)
    assert torch.equal(p_g, p_e) and _same_state(s_g, s_e)
    assert torch.equal(p_g, p_c) and _same_state(s_g, s_c)


# ---- config #2 (20-level fusion, C = 62): layer 1 reads 62 + 64 = 126 -----


def test_config2_layer1_dw_at_b8(device):
    """dW (conv_dw) at config #2's layer 1, B = 8, Cin 126, 256 gate
    columns, k 5, bf16: on the tensor cores, within 1e-3 of the largest
    entry of the per-tap f32 matmul, reruns bit-identical."""
    B, H, W, cin, n, k = 8, 100, 154, 126, 256, 5
    assert convgrad.dw_plan(torch.bfloat16, B, H, W, cin, n, k) == "wgmma"
    gen = torch.Generator(device=device).manual_seed(126)
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    g = torch.randn((B, H, W, n), generator=gen, device=device).bfloat16()
    got, again, want = conv_dw(x, g, k), conv_dw(x, g, k), dw_per_tap(x, g, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, want) <= 1e-3


def test_config2_layer1_b3_at_b8(device):
    """B3 as layer 1's data gradient at config #2 (dgates of hidden 64 ->
    126 channels), B = 8, bf16: within 2e-4 of the largest entry of the
    plain conv, reruns bit-identical."""
    B, H, W, cin, cout, k = 8, 100, 154, 256, 126, 5
    gen = torch.Generator(device=device).manual_seed(127)
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    w = (torch.randn((k, k, cin, cout), generator=gen, device=device)
         / (k * k * cin) ** 0.5).bfloat16()
    got, again, want = conv_same(x, w), conv_same(x, w), conv_same_plain(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, want) <= 2e-4


# ---- the host batch pipeline on the card -----------------------------------


class _Windows:
    def __init__(self, n=12):
        rng = np.random.default_rng(3)
        self.x = rng.standard_normal((n, 4, 3, 10, 16)).astype(np.float32)
        self.y = rng.standard_normal((n, 10, 16)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_async_batches_pinned_side_stream_prefetch(device):
    """On the card every batch tensor is copied from a pinned host buffer on
    a stream other than the consumer's, arrives on the device in
    batch_iterator's order, and equals the host batch."""
    from nasa_niswan_tpu_torch.data import pipeline

    ds = _Windows()
    want = list(pipeline.batch_iterator(ds, 4, seed=2, epoch=1))
    before = (pipeline.h2d_copies, pipeline.h2d_pinned, pipeline.h2d_side_stream)
    got = []
    for batch in pipeline.async_batches(ds, 4, seed=2, epoch=1, device=device):
        assert all(t.device == device for t in batch)
        got.append(tuple(t * 1 for t in batch))  # a kernel on the consumer's stream
    after = (pipeline.h2d_copies, pipeline.h2d_pinned, pipeline.h2d_side_stream)
    assert [a - b for a, b in zip(after, before)] == [2 * len(want)] * 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.cpu().numpy(), b)


def test_chunk_drain_fetches_device_chunks_one_behind(device):
    from nasa_niswan_tpu_torch.data.pipeline import ChunkDrain

    drain = ChunkDrain()
    chunks = [torch.full((3, 5), float(i), device=device) for i in range(3)]
    for c in chunks:
        drain.push(c)
    out = drain.finish()
    assert [float(o[0, 0]) for o in out] == [0.0, 1.0, 2.0]
    assert all(isinstance(o, np.ndarray) for o in out)


def test_streamed_fit_equals_resident_fit_on_the_card(device, tmp_path):
    """``fit(device_resident=False)`` on the card: the same losses and
    weights as the resident route, bit for bit (the same kernels on the
    same batches), bf16 at a small size."""
    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    data = synthetic_e33oma_90d(T=40, H=16, W=24, seed=1)
    train, val = (SequenceDataset(data, period=p, sequence_length=4) for p in ("train", "val"))
    kw = dict(in_channels=5, hidden_channels=(16, 8), kernel_sizes=(5, 3),
              compute_dtype="bfloat16")
    cfg = TrainConfig(model="LSTM-c", num_layers=2, hidden_channels=(16, 8),
                      kernel_size=(5, 3), batch_size=3, num_epochs=1, input_size=(20, 28),
                      checkpoint_every=0, snapshot_dir=str(tmp_path),
                      compute_dtype="bfloat16", device=str(device))
    outs = []
    for resident in (True, False):
        bundle = build_model("LSTM-c", **kw)
        params, _ = bundle.init(torch.Generator().manual_seed(0), device)
        outs.append(fit(bundle, train, val, cfg, device=device, device_resident=resident,
                        init_params=params, verbose=False))
    assert outs[0]["logger"] == outs[1]["logger"]
    for a, b in zip(param_leaves(outs[0]["params"]), param_leaves(outs[1]["params"])):
        assert torch.equal(a, b)


# ---- serving as CUDA graphs (graph.py) -----------------------------------------

G_CFG = dict(in_channels=8, hidden_channels=(16, 8, 8), kernel_sizes=(5, 3, 3))
G_GEO = dict(padded_shape=(20, 28), grid_shape=(16, 24))


def _g_setup(device, dtype="bfloat16", seed=0):
    cfg = ConvLSTMConfig(compute_dtype=dtype, **G_CFG)
    params = convlstm_init(torch.Generator().manual_seed(seed), cfg, device=device)
    rng = np.random.default_rng(seed)
    norm = Normalizer(rng.standard_normal(8).astype(np.float32),
                      (1.0 + rng.random(8)).astype(np.float32), 0.5, 2.0)
    forcings = torch.tensor(rng.standard_normal((4, 1, 6, 8, 16, 24)),
                            dtype=torch.float32, device=device)
    return cfg, params, norm, forcings


def _same_state(a, b):
    return all(torch.equal(x, y) for hc_a, hc_b in zip(a, b) for x, y in zip(hc_a, hc_b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hoist", [False, True])
def test_graph_rollout_equals_eager_chained_and_chunked(device, dtype, hoist):
    """Four requests chained through the carry, bit-equal to the eager
    body; one request equal to two chunks of it; the outputs handed back
    survive the next replay."""
    cfg, params, norm, forcings = _g_setup(device, dtype)
    rollout = make_rollout_fn(cfg, norm, precompute_input_conv=hoist, device=device, **G_GEO)
    st_g = st_e = None
    kept = []
    for f in forcings:
        p_g, st_g = rollout(params, f, st_g)
        p_e, st_e = rollout.eager(params, f, st_e)
        kept.append((p_g, p_g.clone()))
        assert torch.equal(p_g, p_e) and _same_state(st_g, st_e)
    assert rollout.runner.captures == 1
    assert all(torch.equal(a, b) for a, b in kept)
    p_a, s_a = rollout(params, forcings[0][:, :3])
    p_b, s_b = rollout(params, forcings[0][:, 3:], s_a)
    p_one, s_one = rollout(params, forcings[0])
    assert torch.equal(torch.cat([p_a, p_b], dim=1), p_one) and _same_state(s_b, s_one)


def test_graph_streaming_equals_eager(device):
    cfg, params, norm, forcings = _g_setup(device)
    step = make_streaming_rollout(cfg, norm, params, device=device, **G_GEO)
    rollout = make_rollout_fn(cfg, norm, device=device, **G_GEO)
    frames = torch.cat([forcings[0], forcings[1]], dim=1)  # 12 steps
    want, st = rollout.eager(params, frames[:, :10])
    for t in range(10):
        assert torch.equal(step(frames[:, t]), want[:, t])
        carry = [x for hc in step.carry() for x in hc]
        assert all(a is b for a, b in zip(carry, step.runner.last_inputs[1:]))
    assert step.runner.captures == 1 and _same_state(step.carry(), st)


def test_graph_recaptures_after_an_in_place_weight_change(device):
    """An Adam step changes the weights in place (same storage): the next
    request must read the new weights, as the eager body does."""
    cfg, params, norm, forcings = _g_setup(device)
    params = {"cells": [{k: v.clone().requires_grad_(True) for k, v in c.items()}
                        for c in params["cells"]],
              "head": {k: v.clone().requires_grad_(True) for k, v in params["head"].items()}}
    rollout = make_rollout_fn(cfg, norm, device=device, **G_GEO)
    before, _ = rollout(params, forcings[0])
    leaves = [t for c in params["cells"] for t in c.values()] + list(params["head"].values())
    opt = torch.optim.Adam(leaves, lr=1e-2)
    for t in leaves:
        t.grad = torch.ones_like(t)
    opt.step()
    after, _ = rollout(params, forcings[0])
    want, _ = rollout.eager(params, forcings[0])
    assert torch.equal(after, want) and not torch.equal(after, before)
    assert rollout.runner.captures == 2
    new_tree = {"cells": [{k: v.detach() * 0.5 for k, v in c.items()} for c in params["cells"]],
                "head": {k: v.detach() for k, v in params["head"].items()}}
    got, _ = rollout(new_tree, forcings[0])
    want, _ = rollout.eager(new_tree, forcings[0])
    assert torch.equal(got, want) and rollout.runner.captures == 3


def test_graph_replay_span_holds_the_replays_device_time(device):
    """Under a profiler a serving replay's span (utils/profiling.span) has
    device seconds above 0 and no more than its host window plus the wait
    for the card; outside one the runner records nothing."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from nasa_niswan_tpu_torch.utils.profiling import spans

    cfg, params, norm, forcings = _g_setup(device)
    rollout = make_rollout_fn(cfg, norm, device=device, **G_GEO)
    rollout(params, forcings[0])  # the capture and a replay, untraced
    torch.cuda.synchronize(device)
    n = len(spans("niswan.graph.replay"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rollout(params, forcings[1])
        torch.cuda.synchronize(device)
        done = time.perf_counter_ns()
    assert len(spans("niswan.graph.replay")) == n + 1
    rec = spans("niswan.graph.replay")[-1]
    assert rec.parent is spans("niswan.graph.run")[-1]
    assert rec.parent.parent is spans("niswan.serve.chunk")[-1]
    assert 0 < rec.device_s <= (done - rec.start_ns) / 1e9


def test_kernel_load_is_counted_after_the_first_launch(device):
    from nasa_niswan_tpu_torch.utils.profiling import counters

    fused_cell_forward(*_cell_inputs(device, torch.bfloat16, 1, 16, 24, 9, 8, 3))
    torch.cuda.synchronize(device)
    assert counters()["kernels.load_s"] > 0


@pytest.mark.parametrize("hoist", [False, True])
def test_graph_launch_counts_per_replay(device, hoist):
    """The first call warms up on one step, captures and replays once; then
    each replay adds exactly what it launched."""
    cfg, params, norm, forcings = _g_setup(device)
    rollout = make_rollout_fn(cfg, norm, precompute_input_conv=hoist, device=device, **G_GEO)
    counts = lambda: (convlstm_cell.launches, convlstm_cell.xg_launches,  # noqa: E731
                      convgrad.conv_same_launches)
    before = counts()
    rollout(params, forcings[0])  # a one-step warm-up, the capture, one replay
    first = [a - b for a, b in zip(counts(), before)]
    assert first == ([2 * 7, 7, 2] if hoist else [3 * 7, 0, 0])
    before = counts()
    for f in forcings:
        rollout(params, f)
    got = [a - b for a, b in zip(counts(), before)]
    n = 4 * 6
    assert got == ([2 * n, n, 4] if hoist else [3 * n, 0, 0])


def test_graph_closed_loop_chunk_equals_eager(device):
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        make_closed_loop_chunk,
        zero_closed_loop_state,
    )

    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=(16, 8, 8), kernel_sizes=(5, 3, 3),
                         compute_dtype="bfloat16")
    params = convlstm_init(torch.Generator().manual_seed(1), cfg, device=device)
    rng = np.random.default_rng(1)
    norm = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.1, 1.5)
    frames = torch.tensor(rng.standard_normal((10, 5, 16, 24)), dtype=torch.float32,
                          device=device)
    run = make_closed_loop_chunk(cfg, norm, **G_GEO)
    st_g = st_e = zero_closed_loop_state(cfg, G_GEO["padded_shape"], device)
    prev_g = prev_e = torch.zeros((1, 16, 24), device=device)
    for s in (0, 5):
        st_g, prev_g, p_g = run(params, st_g, prev_g, frames[s : s + 5])
        st_e, prev_e, p_e = run.eager(params, st_e, prev_e, frames[s : s + 5])
        assert torch.equal(p_g, p_e) and torch.equal(prev_g, prev_e)
        assert _same_state(st_g, st_e)
    assert run.runner.captures == 1


@pytest.mark.parametrize("shared", [False, True])
def test_graph_multitracer_equals_single_rollouts(device, shared):
    """S = 3 species in one graph, bit-equal to three single rollouts
    (f32: the shared variant casts its meteorology where the single
    rollout does, so f32 keeps every value equal)."""
    from nasa_niswan_tpu_torch.rollout import multitracer as mt

    cfg = ConvLSTMConfig(compute_dtype="float32", **G_CFG)
    rng = np.random.default_rng(2)
    params = [convlstm_init(torch.Generator().manual_seed(s), cfg, device=device)
              for s in range(3)]
    norms = [Normalizer(np.append(np.zeros(7), 0.1 * s).astype(np.float32),
                        np.ones(8, np.float32), 0.2 * s, 1.0 + s) for s in range(3)]
    met = torch.tensor(rng.standard_normal((1, 6, 7, 16, 24)), dtype=torch.float32,
                       device=device)
    emis = torch.tensor(rng.random((3, 1, 6, 16, 24)), dtype=torch.float32, device=device)
    forcings = torch.stack([torch.cat([met, emis[s][:, :, None]], dim=2) for s in range(3)])
    if shared:
        roll = mt.make_multitracer_rollout_shared(cfg, norms, **G_GEO)
        got, _ = roll(mt.stack_params(params), met, emis)
    else:
        roll = mt.make_multitracer_rollout(cfg, norms, **G_GEO)
        got, _ = roll(mt.stack_params(params), forcings)
    assert roll.runner.captures == 1
    for s in range(3):
        want, _ = make_rollout_fn(cfg, norms[s], device=device, **G_GEO).eager(
            params[s], forcings[s])
        assert torch.equal(got[s], want)


def test_exported_artifact_on_the_card_equals_the_live_rollout(device, tmp_path):
    """Exported on the card, B1 is traced as niswan::convlstm_cell; the
    loaded program, replayed as a graph, serves what the live rollout
    serves."""
    from nasa_niswan_tpu_torch.rollout.export import (
        export_rollout,
        initial_rollout_state,
        load_rollout_info,
    )

    cfg, params, norm, forcings = _g_setup(device)
    path = str(tmp_path / "r.pt2")
    export_rollout(cfg, norm, params, batch=1, chunk_steps=6, n_channels=8,
                   path=path, **G_GEO)
    fn, sig = load_rollout_info(path)
    assert sig == (1, 6, 8, 16, 24)
    live = make_rollout_fn(cfg, norm, device=device, **G_GEO)
    st, st_l = initial_rollout_state(cfg, 1, G_GEO["padded_shape"], device), None
    for f in forcings[:2]:
        p, st = fn(f, st)
        q, st_l = live(params, f, st_l)
        assert torch.equal(p, q) and _same_state(st, st_l)
    assert fn.runner.captures == 1 and fn.device.type == "cuda"
    with pytest.raises(ValueError, match="exported for cuda"):
        load_rollout_info(path, device="cpu")


def _unet(device, in_channels, features=(8, 16, 32, 64)):
    from nasa_niswan_tpu_torch import bridge
    from nasa_niswan_tpu_torch.models.registry import build_model

    bundle = build_model("UNet-c", in_channels=in_channels, unet_features=features)
    params, state = bundle.init(torch.Generator().manual_seed(0), "cpu")
    # running statistics set to a random batch's, so that eval normalizes
    # as training does (fresh ones leave only the head's bias in the output)
    x = torch.randn((2, 64, 64, in_channels), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, new = bundle.apply(params, state, x, training=True)
    state = bridge.tree_unflatten(state, [
        (n - 0.9 * o) / 0.1 for n, o in zip(bridge.tree_leaves(new), bridge.tree_leaves(state))])
    to = lambda tree: bridge.tree_map(lambda t: t.detach().to(device), tree)  # noqa: E731
    return bundle, params, state, to(params), to(state)


@pytest.mark.parametrize("training", [False, True])
def test_unet_forward_on_the_card_equals_the_cpu(device, training):
    """cuDNN's f32 convs (TF32 off) against the CPU's on the same weights:
    the output and the new running statistics within 1e-4 of their largest
    magnitude."""
    from nasa_niswan_tpu_torch import bridge

    bundle, params, state, p_dev, s_dev = _unet(device, 5)
    x = torch.tensor(np.random.default_rng(4).standard_normal((4, 64, 64, 5)),
                     dtype=torch.float32)
    with torch.no_grad():
        want, want_s = bundle.apply(params, state, x, training=training)
        got, got_s = bundle.apply(p_dev, s_dev, x.to(device), training=training)
    for g, w in zip(bridge.tree_leaves((got, got_s)), bridge.tree_leaves((want, want_s))):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


def test_graph_unet6_feedback_chunk_equals_eager(device):
    """The UNet-6ch closed loop: each chunk one graph replay, bit-equal to
    the eager body, the feedback frame chained across two chunks; the
    chunk captures once, and its graph, which reads the weights live,
    serves an in-place change of them without a recapture."""
    from nasa_niswan_tpu_torch.evalx.evaluate import make_feedback_chunk

    bundle, _, _, params, state = _unet(device, 6)
    rng = np.random.default_rng(5)
    norm = Normalizer(rng.uniform(-0.2, 0.2, 6).astype(np.float32),
                      rng.uniform(0.8, 1.2, 6).astype(np.float32), 0.1, 1.5)
    frames = torch.tensor(rng.standard_normal((10, 6, 48, 60)), dtype=torch.float32,
                          device=device)
    run = make_feedback_chunk(bundle, norm, padded_shape=(64, 64), grid_shape=(48, 60))
    prev_g = prev_e = frames[0, 5]
    for s in (0, 5):
        _, prev_g, p_g = run(params, state, prev_g, frames[s : s + 5])
        _, prev_e, p_e = run.eager(params, state, prev_e, frames[s : s + 5])
        assert torch.equal(p_g, p_e) and torch.equal(prev_g, prev_e)
    assert run.runner.captures == 1
    params["head"]["b"].add_(0.5)
    _, _, p_g = run(params, state, prev_g, frames[:5])
    _, _, p_e = run.eager(params, state, prev_g, frames[:5])
    assert torch.equal(p_g, p_e) and run.runner.captures == 1


# ---- parallel/: B1 on halo-extended tiles, one-rank NCCL, two ranks ----

# the three serving layers of the canonical model (C = 62), B = 1
SERVING_LAYERS = [(1, 100, 154, 62 + 64, 64, 5), (1, 100, 154, 64 + 32, 32, 3),
                  (1, 100, 154, 32 + 16, 16, 3)]


@pytest.mark.parametrize("tiles", [(1, 1), (2, 2), (2, 7), (5, 2)], ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("shape", SERVING_LAYERS, ids=lambda s: f"k{s[-1]}-hid{s[-2]}")
def test_tiled_cell_on_the_card_equals_the_full_grid(device, shape, tiles):
    """B1 (bf16) on every halo-extended tile of a (lat, lon) cut of the
    100 x 154 frame (halos sliced from the zero-padded frame; tiles such as
    54 x 81, 54 x 26, 24 x 81, and at (1, 1) the 104 x 158 / 102 x 156
    frame of the one-rank sharded path) agrees with the plain cell on its
    inputs (|d| <= 1e-3, B1's limit), and the tiles stitched equal B1 on
    the whole frame bit for bit: a pixel's sum does not depend on where it
    lies in a tile."""
    import torch.nn.functional as F

    B, H, W, cin, hid, k = shape
    lat, lon = tiles
    p, th, tw = k // 2, H // lat, W // lon
    xh, c, w, b = _cell_inputs(device, torch.bfloat16, *shape)
    h_full, c_full = fused_cell_forward(xh, c, w, b)
    xp, cp = (F.pad(t, (0, 0, p, p, p, p)) for t in (xh, c))
    h_st, c_st = torch.empty_like(h_full), torch.empty_like(c_full)
    for i in range(lat):
        for j in range(lon):
            rows, cols = slice(i * th, i * th + th + 2 * p), slice(j * tw, j * tw + tw + 2 * p)
            tile = (xp[:, rows, cols].contiguous(), cp[:, rows, cols].contiguous(), w, b)
            ht, ct = fused_cell_forward(*tile)
            hp, cpl = fused_cell_forward_plain(*tile)
            assert (ht - hp).abs().max().item() <= 1e-3
            assert (ct - cpl).abs().max().item() <= 1e-3
            h_st[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = ht[:, p:p + th, p:p + tw]
            c_st[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = ct[:, p:p + th, p:p + tw]
    assert torch.equal(h_st, h_full) and torch.equal(c_st, c_full)


@pytest.fixture
def nccl_world1(device, tmp_path):
    """A one-rank NCCL group in this process, destroyed after the test."""
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(f"file://{tmp_path}/store", 1, 0, device_type="cuda")
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def _max_std(got, want):
    assert got.shape == want.shape
    return ((got - want).float().abs().max() / want.float().std()).item()


def test_sharded_rollout_world1_nccl(device, nccl_world1):
    """On a one-rank NCCL mesh (1, 1, 1) the sharded rollout (two chained
    chunks) and the sharded closed loop equal the graph-replayed
    single-device rollout and closed-loop chunk: the same B1 launches on
    the same data, so bit-equal is expected and max |d| <= 1e-6 of the std
    is held (TOL_CHUNK of chip_smoke.py), predictions and carries."""
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        make_closed_loop_chunk,
        zero_closed_loop_state,
    )
    from nasa_niswan_tpu_torch.parallel import spatial

    mesh = nccl_world1
    cfg = ConvLSTMConfig(in_channels=8, hidden_channels=(16, 8, 8), kernel_sizes=(5, 3, 3),
                         compute_dtype="bfloat16")
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(6)
    f = torch.tensor(rng.standard_normal((1, 12, 8, 16, 24)), dtype=torch.float32,
                     device=device)
    norm = Normalizer(np.zeros(8, np.float32), np.ones(8, np.float32), 0.2, 1.5)
    geo = dict(padded_shape=(20, 28), grid_shape=(16, 24))
    sh = spatial.make_sharded_rollout_fn(cfg, norm, mesh, **geo)
    ref = make_rollout_fn(cfg, norm, **geo)
    s_sh = s_ref = None
    for part in (f[:, :6], f[:, 6:]):
        p_sh, s_sh = sh(params, part, s_sh)
        p_ref, s_ref = ref(params, part, s_ref)
        assert _max_std(p_sh, p_ref) <= 1e-6
    for (h, c), (rh, rc) in zip(spatial.gather_state(s_sh, mesh), s_ref):
        assert _max_std(h, rh) <= 1e-6 and _max_std(c, rc) <= 1e-6
    fb_norm = Normalizer(np.zeros(7, np.float32), np.ones(7, np.float32), 0.2, 1.5)
    prev = f[0, 0, :1] * 0.1
    x = f[0, :, :7]
    st_r, prev_r, fb_r = make_closed_loop_chunk(cfg, fb_norm, **geo)(
        params, zero_closed_loop_state(cfg, (20, 28), device), prev, x)
    st_s, prev_s, fb_s = spatial.make_sharded_feedback_rollout(cfg, fb_norm, mesh, **geo)(
        params, None, prev, x)
    assert _max_std(fb_s, fb_r) <= 1e-6 and _max_std(prev_s, prev_r) <= 1e-6
    for (h, c), (rh, rc) in zip(spatial.gather_state(st_s, mesh), st_r):
        assert _max_std(h, rh) <= 1e-6 and _max_std(c, rc) <= 1e-6


def test_sharded_entry_points_replay_their_eager_body_world1_nccl(device, nccl_world1):
    """On a one-rank NCCL mesh each sharded serving entry point's call is a
    CUDA graph replay (one capture per signature), bit-equal to its eager
    body over two chained chunks, and counts B1's launches once per
    replay."""
    from nasa_niswan_tpu_torch.parallel import spatial
    from nasa_niswan_tpu_torch.rollout.multitracer import stack_params

    mesh = nccl_world1
    cfg = ConvLSTMConfig(in_channels=8, hidden_channels=(16, 8, 8), kernel_sizes=(5, 3, 3),
                         compute_dtype="bfloat16")
    geo = dict(padded_shape=(20, 28), grid_shape=(16, 24))
    params = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    stacked = stack_params([convlstm_init(torch.Generator().manual_seed(s), cfg,
                                          device=device) for s in (1, 2)])
    rng = np.random.default_rng(7)
    f = torch.tensor(rng.standard_normal((2, 1, 8, 8, 16, 24)), dtype=torch.float32,
                     device=device)
    norm = Normalizer(np.zeros(8, np.float32), np.ones(8, np.float32), 0.2, 1.5)
    fb_norm = Normalizer(np.zeros(7, np.float32), np.ones(7, np.float32), 0.2, 1.5)
    entries = {
        "rollout": (spatial.make_sharded_rollout_fn(cfg, norm, mesh, **geo),
                    lambda fn, st, k: fn(params, f[0, :, 4 * k:4 * k + 4], st), 3),
        "multi": (spatial.make_sharded_multitracer_rollout(cfg, [norm] * 2, mesh, **geo),
                  lambda fn, st, k: fn(stacked, f[:, :, 4 * k:4 * k + 4], st), 6),
        "shared": (spatial.make_sharded_multitracer_rollout_shared(cfg, [norm] * 2, mesh,
                                                                   **geo),
                   lambda fn, st, k: fn(stacked, f[0, :, 4 * k:4 * k + 4, :7],
                                        f[:, :, 4 * k:4 * k + 4, 7], st), 6),
        "feedback": (spatial.make_sharded_feedback_rollout(cfg, fb_norm, mesh, **geo),
                     lambda fn, st, k: (lambda o: (o[2], o[:2]))(
                         fn(params, *(st or (None, f[0, 0, :1, 0])),
                            f[0, 0, 4 * k:4 * k + 4, :7])), 3),
    }
    for name, (fn, step, cells) in entries.items():
        outs = {}
        for run in (fn, fn.eager):
            carry, preds = None, []
            for k in range(2):
                p, carry = step(run, carry, k)
                preds.append(p)
            outs[run is fn] = (preds, carry)
        (g_p, g_c), (e_p, e_c) = outs[True], outs[False]
        assert all(torch.equal(a, b) for a, b in zip(g_p, e_p)), name
        if name == "feedback":
            g_c, e_c = g_c[0], e_c[0]
        assert all(torch.equal(a, b) for hc_g, hc_e in zip(g_c, e_c)
                   for a, b in zip(hc_g, hc_e)), name
        assert fn.runner.captures == 1, name
        before = convlstm_cell.launches
        step(fn, None, 0)
        assert convlstm_cell.launches - before == cells * 4, name


def test_two_rank_nccl_sharded_rollout_and_dp_step(device):
    """Two ranks on two cards (launch.spawn, NCCL): the (1, 1, 2) sharded
    rollout against the single-device rollout (max |d| <= 1e-6 of the std:
    B1's sums do not depend on the tile), the dp = 2 step's loss against
    the one-rank step's (chip_smoke.py's two-rank phase, small)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    import chip_smoke
    from nasa_niswan_tpu_torch.parallel import launch

    out = launch.spawn(chip_smoke.two_rank_phase, 2, "cuda", "cuda", dict(
        C=8, hidden=(16, 8, 8), kernels=(5, 3, 3), grid=(16, 24), padded=(20, 28),
        steps=6, bs=4, T=4), timeout=600)
    assert out[0]["rollout_max"] <= 1e-6 and out[0]["dp_loss_rel"] <= 1e-5


@pytest.mark.parametrize("route", ["remat", "per-cell"])
def test_spatial_step_world1_nccl_matches_the_device_step(device, nccl_world1, route):
    """On a one-rank NCCL mesh the spatially sharded step (the tile is the
    zero-extended frame: B1, B2 and B3 on 24 x 32 / 22 x 30 tiles) leaves
    the single-device step's gradients, f32: within 1e-5 of each leaf's
    largest (sums over the zero ring in another order)."""
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step

    bundle = build_model("LSTM-t", remat=route == "remat", in_channels=5,
                         hidden_channels=(16, 8), kernel_sizes=(5, 3))
    init, _ = bundle.init(torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 6, 5, 16, 24)), dtype=torch.float32,
                     device=device)
    y = torch.tensor(rng.standard_normal((4, 16, 24)), dtype=torch.float32, device=device)
    norm = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    geo = dict(padded_shape=(20, 28), grid_shape=(16, 24))
    grads = []
    for make in (lambda p: make_spatial_train_step(
            bundle, norm, make_optimizer(p, 1e-3, (0.5, 0.999)), nccl_world1, **geo),
            lambda p: make_train_step(bundle, norm, make_optimizer(p, 1e-3, (0.5, 0.999)),
                                      **geo)):
        p = {"cells": [{k: v.detach().clone().requires_grad_(True) for k, v in c.items()}
                       for c in init["cells"]],
             "head": {k: v.detach().clone().requires_grad_(True)
                      for k, v in init["head"].items()}}
        make(p)(p, None, x, y)
        grads.append([t.grad for t in param_leaves(p)])
    for a, b in zip(*grads):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("shape", [(8, 54, 81, 72, 64, 5), (8, 52, 24, 48, 16, 3),
                                   (3, 29, 37, 40, 32, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernels_on_tile_shapes(device, shape):
    """B2, its dW kernels alone and B3 at halo-extended tile shapes (ragged
    widths) against their plain versions, bf16 (chip_smoke.py (f)'s
    bounds)."""
    B, H, W, cin, hid, k = shape
    gen = torch.Generator(device=device).manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    xh, c, dh, dc = rand(B, H, W, cin).bfloat16(), rand(B, H, W, hid), rand(B, H, W, hid), \
        rand(B, H, W, hid)
    w = (rand(k, k, cin, 4 * hid) / (k * k * cin) ** 0.5).bfloat16()
    b = 0.1 * rand(4 * hid)
    got, want = fused_cell_bwd(xh, c, dh, dc, w, b), fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    assert ((got[1] - want[1]).abs().max() <= 1e-4).item()
    for g, r, tol in ((got[2], want[2], 1e-3), (got[3], want[3], 1e-4)):
        assert ((g - r).abs().max() / r.abs().max()).item() <= tol
    dw = conv_dw(xh, want[0], k)
    assert ((dw - dw_per_tap(xh, want[0], k)).abs().max() / dw.abs().max()).item() <= 1e-3
    w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
    dx, dx_plain = conv_same(want[0], w_flip), conv_same_plain(want[0], w_flip)
    assert ((dx - dx_plain).abs().max() / dx_plain.abs().max()).item() <= 2e-4


def test_async_checkpoint_of_card_tensors(device, tmp_path):
    """``AsyncCheckpointer.save`` copies card tensors to pinned memory on a
    side stream and returns; an in-place update queued right after it (the
    next Adam step) does not reach the checkpoint."""
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.train.checkpoint import param_leaves
    from nasa_niswan_tpu_torch.train.checkpoint_async import AsyncCheckpointer
    from nasa_niswan_tpu_torch.train.loop import make_optimizer

    bundle = build_model("UNet-ck", in_channels=5, unet_features=(8, 16, 32, 64))
    params, state = bundle.init(torch.Generator().manual_seed(0), device)
    opt = make_optimizer(params, 1e-3, (0.5, 0.999))
    out, state = bundle.apply(params, state, torch.randn(2, 32, 32, 5, device=device),
                              training=True)
    out.square().mean().backward()
    opt.step()
    before = [t.detach().clone() for t in param_leaves(params)]
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(1, params, opt, model_state=state)
    with torch.no_grad():
        for t in param_leaves(params):
            t.mul_(2.0).add_(1.0)
    ck.close()
    tmpl, tmpl_state = bundle.init(torch.Generator().manual_seed(1), device)
    p, _, s, meta = AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(
        tmpl, state_template=tmpl_state)
    assert meta["epoch"] == 1
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(p), before))


def test_step_timer_reads_cuda_events(device):
    from nasa_niswan_tpu_torch.utils.profiling import StepTimer, device_sync

    timer = StepTimer(steps_per_day=48, sync_every=2)
    x = torch.ones(1024, 1024, device=device)
    for _ in range(6):
        x = x @ x / 1024.0
        timer.tick({"x": x}, n_steps=48, batch=1)
    device_sync(x)
    assert isinstance(timer._mark, torch.cuda.Event)
    assert timer.summary()["windows"] == 2 and timer.summary()["model_days_per_min"] > 0


def test_unet_dp_world1_nccl_matches_the_device_step(device, nccl_world1):
    """The UNet's DP step on a one-rank NCCL mesh (BatchNorm sums
    all-reduced) against the single-device step, f32 (chip_smoke.py's
    ``unet_dp_errors``): the f64 gradients per leaf within 1e-5 of the
    leaf's largest, dp against one device and both against the f64 loss
    gradient; the f32 running statistics within 1e-5 of each leaf's
    largest, the conv biases ahead of BatchNorm below 1e-6."""
    import chip_smoke
    from nasa_niswan_tpu_torch.models.registry import build_model

    bundle = build_model("UNet-dp", in_channels=5, unet_features=(8, 16, 32, 64))
    p0, s0 = bundle.init(torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(2)
    batch = (torch.tensor(rng.standard_normal((4, 5, 16, 24)), dtype=torch.float32,
                          device=device),
             torch.tensor(rng.standard_normal((4, 16, 24)), dtype=torch.float32,
                          device=device))
    norm = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    e = chip_smoke.unet_dp_errors(bundle, p0, s0, batch, norm, (32, 32), (16, 24),
                                  nccl_world1)
    for key in ("f64_dp", "f64_one", "f64_d"):
        assert max(e[key].values()) <= 1e-5, (key, e[key])
    assert e["state"] <= 1e-5 and e["noise"] <= 1e-6


def test_two_rank_nccl_spatial_steps(device):
    """chip_smoke.py (t)'s two-rank part, small: the (1, 1, 2) and (1, 2,
    1) sharded steps on two cards against the one-device step, f32."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    import chip_smoke
    from nasa_niswan_tpu_torch.parallel import launch

    out = launch.spawn(chip_smoke.two_rank_spatial_phase, 2, "cuda", dict(
        grid=(16, 24), padded=(20, 28), hidden=(16, 8), kernels=(5, 3), bs=4, T=4,
        dtype="float32"), timeout=600)
    assert all(v["loss_rel"] <= 1e-5 and v["grad_rel"] <= 1e-4 for v in out[0].values())
