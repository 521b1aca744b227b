"""The weight gradient (B2's dW, ``conv_dw``) and the SAME conv (B3,
``conv_same``) of the PyTorch port at ragged channel counts, against the JAX
package, plus emulations of the two tensor-core kernels' loop nests.

* The plain versions (what the CPU runs) against the JAX package: ``conv_dw``
  against ``_conv_grads`` (the XLA weight gradient of the JAX per-cell
  route), ``conv_same`` against ``conv_same_v2`` and ``fused_cell_bwd``
  against ``fused_cell_bwd_v2``, both in Pallas interpret mode.
* A torch emulation of each kernel's loop nest (``csrc/cell_bwd.cu``
  ``dw_mma_kernel_wgmma`` and ``csrc/conv_same.cu`` ``conv_same_mma_kernel``):
  their plans, pixel tiles, haloes, tap offsets, zero-filled channel groups,
  the dW kernel's staged images, ldmatrix addresses and descriptor reads,
  slot split and in-order slot sum, written out index by index as the
  kernels compute them, against the plain versions at ragged H, W and Cin.
  The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
* The rollout's device: parameters off the CPU take the forcings with them.

Inputs are seeded numpy, handed to both packages; shapes are small."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.ops import convgrad_pallas as jcg  # noqa: E402
from nasa_niswan_tpu.ops.convlstm_pallas2 import (  # noqa: E402
    _conv_grads,
    pad_cols,
    padded_cols,
)
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import (  # noqa: E402
    ConvLSTMConfig,
    convlstm_init,
)
from nasa_niswan_tpu_torch.ops import convgrad  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import (  # noqa: E402
    make_rollout_fn,
    make_streaming_rollout,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- the plain versions against the JAX package ----------------------------


@pytest.mark.parametrize(
    "cin,k,dtype",
    [(6, 3, "float32"), (14, 5, "float32"), (16, 3, "float32"),
     (22, 3, "bfloat16"), (6, 5, "bfloat16"), (16, 5, "bfloat16")],
)
def test_conv_dw_matches_jax_conv_grads(cin, k, dtype):
    """``conv_dw`` (CPU: one f32 matmul per tap) against the dw of
    ``_conv_grads``, ragged and whole channel groups.  f32: 1e-4 of the
    largest entry (sums in another order).  bf16: the JAX gradient is the
    f32 sum rounded to bf16 (its conv returns the input dtype), at most half
    a bf16 step (2**-8 relative) off each entry; beyond that 2e-3 of the
    largest entry."""
    B, H, W, n = 2, 9, 13, 16
    x, g = _randn(1, B, H, W, cin), _randn(2, B, H, W, n)
    w = _randn(3, k, k, cin, n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, want = _conv_grads(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(g, jdt), k)
    tdt = getattr(torch, dtype)
    got = convgrad.conv_dw(_t(x, tdt), _t(g, tdt), k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k, cin, n)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        assert _rel(got.numpy(), want) <= 1e-4
    else:
        excess = np.abs(got.numpy() - want) - 2.0**-8 * np.abs(want)
        assert excess.max() <= 2e-3 * np.abs(want).max()


@pytest.mark.parametrize("cout,k", [(14, 3), (22, 5), (90, 3)])
def test_conv_same_matches_jax_pallas_ragged_cout(cout, k):
    """B3's plain version against ``conv_same_v2`` (interpret mode) on the
    valid columns, f32, atol 1e-5: output channels that are not multiples of
    8, and one above 80 (two slices of the kernel's widest tile)."""
    B, H, W, cin = 1, 10, 17, 16
    x = _randn(4, B, H, W, cin)
    w = _randn(5, k, k, cin, cout, scale=0.1)
    o = k // 2
    wp = padded_cols(W, o)
    want = jcg.conv_same_v2(pad_cols(jnp.asarray(x), o, wp), jnp.asarray(w), k, o, W,
                            interpret=True)
    got = convgrad.conv_same(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, o : o + W], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cell_bwd_matches_jax_pallas_ragged_cin(dtype):
    """``fused_cell_bwd`` (CPU: plain) against ``fused_cell_bwd_v2``
    (interpret mode) at Cin 22, on the valid columns.  dgates within one
    bf16 step (2**-7 relative) plus 1e-6 in bf16 (1e-5 in f32); dc_prev
    2e-5; db 2e-4; dw 2e-4 in f32 and, in bf16, 2e-3 for sums of ~1,000
    bf16 products of O(1)."""
    B, H, W, C, hid, k = 1, 12, 18, 22, 8, 3
    xh, c, dh, dc = (_randn(10 + i, B, H, W, n) for i, n in enumerate((C, hid, hid, hid)))
    w, b = _randn(14, k, k, C, 4 * hid, scale=0.1), _randn(15, 4 * hid)
    o = k // 2
    wp = padded_cols(W, o)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    m = lambda a: pad_cols(jnp.asarray(a), o, wp)  # noqa: E731
    want = jcg.fused_cell_bwd_v2(m(xh).astype(jdt), m(c), m(dh), m(dc), jnp.asarray(w, jdt),
                                 jnp.asarray(b), k, o, W, interpret=True)
    tdt = getattr(torch, dtype)
    got = convgrad.fused_cell_bwd(_t(xh, tdt), _t(c), _t(dh), _t(dc), _t(w, tdt), _t(b))
    sl = np.s_[:, :, o : o + W]
    rtol = 2.0**-7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32))[sl],
                               rtol=rtol, atol=1e-6 if dtype == "bfloat16" else 1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[sl], atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=2e-3 if dtype == "bfloat16" else 2e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-4)


# ---- the dW kernel's loop nest (csrc/cell_bwd.cu, dw_mma_kernel_wgmma) -----

ROWS, COLS = 8, 16  # pixel tile: one k16 step of 16 pixels per row
SLAB = 64  # gate columns of a dgates slab: 128 bytes a pixel
SLAB_BYTES = ROWS * COLS * 128
SMS, RING, LEAD, MAX_SMEM = 132, 4, 1152, 232448


def _ceil(a, b):
    return -(-a // b)


def _plane_bytes(k):
    """One halo plane: 8 channels of (8+k-1) x (16+k-1) pixels, 16 bytes a
    pixel, 128-byte aligned."""
    return _ceil((ROWS + k - 1) * (COLS + k - 1) * 16, 128) * 128


def _dw_plan(B, H, W, cin, n, k):
    """``plan_dw`` for bf16: octets (8 channels of one tap; octet o is plane
    o // k*k, tap o % k*k), the column tile and accumulators, the octets a
    block owns and the planes its halo holds, the ring, and the slots that
    fill one wave of 132 SMs."""
    cp, np_ = _ceil(cin, 8) * 8, _ceil(n, 8) * 8
    kk = k * k
    octets = kk * cp // 8
    bn = SLAB if n <= SLAB else 2 * SLAB
    acc = 256 // bn
    octs = 16 * acc
    while True:
        span = max((min(octets, o0 + octs) - 1) // kk - o0 // kk + 1
                   for o0 in range(0, octets, octs))
        stage = bn // SLAB * SLAB_BYTES + _ceil(span * _plane_bytes(k), 1024) * 1024
        if octs == 8 or LEAD + 2 * stage <= MAX_SMEM:
            break
        octs -= 8
    plan = dict(cp=cp, np=np_, kk=kk, octets=octets, bn=bn, acc=acc, octs=octs, span=span,
                stage=stage, ring=min(RING, (MAX_SMEM - LEAD) // stage),
                rblocks=_ceil(octets, octs), n_tiles=_ceil(n, bn),
                tiles_w=_ceil(W, COLS), tiles_h=_ceil(H, ROWS))
    plan["smem"] = LEAD + plan["ring"] * stage
    plan["tiles"] = B * plan["tiles_h"] * plan["tiles_w"]
    outs = plan["rblocks"] * plan["n_tiles"]
    slots = min(plan["tiles"], max(1, SMS // outs))
    plan["per"] = _ceil(plan["tiles"], slots)
    plan["slots"] = _ceil(plan["tiles"], plan["per"])
    plan["blocks"] = outs * plan["slots"]
    return plan


def _swizzled(e):
    """The 128-byte swizzle of TMA and of the wgmma descriptor on element
    (bf16) offsets of a 1024-byte aligned buffer: byte bits 4-6 ^= 7-9."""
    return e ^ (((e >> 6) & 7) << 3)


def _stage_images(xp, gp, plan, k, tiles, g_lo, span, n0):
    """The producer's TMA boxes of each tile into its stage, as element
    (bf16) images: BN // 64 slabs of dgates (box: 64 columns from n0 + 64j,
    16 columns, 8 rows; 128-byte swizzle), then `span` halo planes (box: 8
    channels from 8 (g_lo + i), 16+k-1 columns from x0 - k//2, 8+k-1 rows
    from y0 - k//2); every box element out of the tensor reads zero."""
    B, H, W, _ = xp.shape
    P, hw, hh = k // 2, COLS + k - 1, ROWS + k - 1
    # zero borders wide enough for every box
    gz = torch.nn.functional.pad(gp, (0, plan["n_tiles"] * plan["bn"], 0, COLS, 0, ROWS))
    xz = torch.nn.functional.pad(xp, (0, 8 * span, P, hw, P, hh))
    out = torch.zeros((len(tiles), plan["stage"] // 2))
    for ti, t in enumerate(tiles):
        t2, tx = divmod(t, plan["tiles_w"])
        b, ty = divmod(t2, plan["tiles_h"])
        y0, x0 = ty * ROWS, tx * COLS
        for j in range(plan["bn"] // SLAB):
            box = gz[b, y0 : y0 + ROWS, x0 : x0 + COLS, n0 + SLAB * j : n0 + SLAB * (j + 1)]
            lin = torch.arange(SLAB_BYTES // 2)
            out[ti, j * SLAB_BYTES // 2 + _swizzled(lin)] = box.reshape(-1)
        base = plan["bn"] // SLAB * SLAB_BYTES // 2
        for i in range(span):
            c0 = 8 * (g_lo + i)
            box = xz[b, y0 : y0 + hh, x0 : x0 + hw, c0 : c0 + 8]  # rows y0 - P.. (padded by P)
            pl = base + i * _plane_bytes(k) // 2
            out[ti, pl : pl + hh * hw * 8] = box.reshape(-1)
    return out


def _dw_kernel_emulation(x, g, k):
    """dw as ``dw_mma_kernel_wgmma`` computes it.  xh and dgates zero-padded
    to whole 8-channel groups (``pad_channels_kernel``).  Per slot and block
    (row block rb: octets [rb octs, ...); column block: BN columns) each
    tile of the slot is staged as the TMA boxes land (``_stage_images``);
    per tile row r (row pairs holding a row of the frame), each warp's A
    fragment is read at the addresses its lanes give ldmatrix.trans: lane
    l, matrix l // 8 = (pixels 0-7 | 8-15) x (the warp's first | second
    octet), its row pixel 8 (l // 16) + l % 8 at that octet's plane and tap
    shift; B is read through the slab descriptor (MN-major, 128-byte
    swizzle, SBO 1024 bytes along the pixels, LBO a slab along the
    columns).  The epilogue writes octet rows below Cin and columns below N
    into the slot's partial; then the slots are summed in order.  Returns
    (dw, plan, writes), writes counting how often each entry was written
    per slot."""
    B, H, W, cin = x.shape
    n = g.shape[-1]
    p = _dw_plan(B, H, W, cin, n, k)
    kk, hw, acc_n, bn = p["kk"], COLS + k - 1, p["acc"], p["bn"]
    xp = torch.nn.functional.pad(x.float(), (0, p["cp"] - cin))
    gp = torch.nn.functional.pad(g.float(), (0, p["np"] - n))
    halo0 = bn // SLAB * SLAB_BYTES // 2  # the halo's first element in a stage
    row_step = hw * 8  # elements from one tile row of the halo to the next
    # B of tile row 0 through the descriptor: element (pixel kp, column c)
    kp, col = torch.meshgrid(torch.arange(16), torch.arange(bn), indexing="ij")
    b_bytes = (col // SLAB) * SLAB_BYTES + (kp // 8) * 1024 + (kp % 8) * 128 + (col % SLAB) * 2
    b_idx = _swizzled(b_bytes // 2)  # slabs start 1024-aligned
    part = torch.zeros((p["slots"], kk, cin, n))
    writes = torch.zeros((p["slots"], kk, cin, n), dtype=torch.int32)
    for slot in range(p["slots"]):
        tiles = range(slot * p["per"], min(p["tiles"], (slot + 1) * p["per"]))
        for rb in range(p["rblocks"]):
            o0 = rb * p["octs"]
            o_end = min(p["octets"], o0 + p["octs"])
            g_lo = o0 // kk
            span = (o_end - 1) // kk - g_lo + 1
            # A of tile row 0: [warpgroup, accumulator, warp, m16 row, k16 pixel]
            a_idx = torch.zeros((2, acc_n, 4, 16, 16), dtype=torch.long)
            for wg in range(2):
                for a in range(acc_n):
                    for w in range(4):
                        for lane in range(32):
                            m, i = lane // 8, lane % 8
                            o = o0 + (wg * acc_n + a) * 8 + 2 * w + m % 2
                            o = o if o < o_end else o0
                            tap = o % kk
                            pix = 8 * (m // 2) + i
                            addr = (halo0 + (o // kk - g_lo) * _plane_bytes(k) // 2
                                    + ((tap // k) * hw + tap % k + pix) * 8)
                            a_idx[wg, a, w, 8 * (m % 2) : 8 * (m % 2) + 8, pix] = \
                                addr + torch.arange(8)
            for cb in range(p["n_tiles"]):
                n0 = cb * bn
                img = _stage_images(xp, gp, p, k, tiles, g_lo, span, n0)
                accs = torch.zeros((2, acc_n, 4, 16, bn))
                for ti, t in enumerate(tiles):
                    y0 = (t // p["tiles_w"]) % p["tiles_h"] * ROWS
                    for r in range(2 * _ceil(min(ROWS, H - y0), 2)):
                        a_mat = img[ti][a_idx + r * row_step]
                        b_mat = img[ti][b_idx + r * (2048 // 2)]
                        accs += a_mat @ b_mat
                for wg in range(2):
                    for a in range(acc_n):
                        for w in range(4):
                            for h in range(2):
                                o = o0 + (wg * acc_n + a) * 8 + 2 * w + h
                                cs = min(8, cin - 8 * (o // kk))
                                ns = min(bn, n - n0)
                                if o >= o_end or cs <= 0:
                                    continue
                                c0 = 8 * (o // kk)
                                part[slot, o % kk, c0 : c0 + cs, n0 : n0 + ns] = \
                                    accs[wg, a, w, 8 * h : 8 * h + cs, :ns]
                                writes[slot, o % kk, c0 : c0 + cs, n0 : n0 + ns] += 1
    dw = part[0].clone()
    for s in range(1, p["slots"]):  # sum_slots_kernel: slots in order
        dw = dw + part[s]
    return dw.reshape(k, k, cin, n), p, writes


@pytest.mark.parametrize(
    "B,H,W,cin,n,k",
    [(2, 9, 37, 22, 40, 5),  # ragged rows, columns, channels and N
     (1, 11, 19, 6, 96, 3),  # Cin 6: one plane, two zero channels; 32 zero columns
     (1, 6, 17, 40, 40, 7),  # k 7, 5 planes
     (1, 9, 21, 70, 256, 5),  # config #3's Cin 70: 9 planes, two column blocks
     (1, 7, 18, 126, 256, 5),  # config #2's Cin 126: 16 planes, 13 row blocks
     (1, 10, 17, 126, 128, 7),  # k 7 at 126 channels: 25 row blocks
     (2, 5, 33, 6, 32, 7),  # 32 columns of a 64-wide tile
     (1, 13, 20, 22, 64, 3),  # four m64n64 accumulators a warpgroup
     (1, 9, 16, 70, 128, 3),
     (1, 12, 15, 6, 256, 5),
     (1, 17, 9, 126, 64, 3),
     (2, 8, 16, 22, 128, 7),
     (1, 11, 23, 70, 32, 7),
     (1, 9, 13, 126, 32, 3),
     (1, 6, 35, 8, 256, 5),  # the hoisted input conv's Cin 8: one plane
     (3, 4, 5, 5, 16, 1)],  # k 1
)
def test_dw_kernel_loop_nest_matches_plain(B, H, W, cin, n, k):
    """The emulated dW kernel equals ``dw_per_tap`` to f32 rounding (1e-5 of
    the largest entry), every dw entry is written exactly once per slot, the
    plan's slots cover every tile once and no slot is empty."""
    x, g = _t(_randn(20, B, H, W, cin)), _t(_randn(21, B, H, W, n))
    got, plan, writes = _dw_kernel_emulation(x, g, k)
    assert (writes == 1).all()
    assert (plan["slots"] - 1) * plan["per"] < plan["tiles"] <= plan["slots"] * plan["per"]
    assert _rel(got.numpy(), convgrad.conv_dw(x, g, k).numpy()) <= 1e-5


@pytest.mark.parametrize(
    "shape,want",
    [  # (B, H, W, Cin, N, k): (row blocks, column blocks, slots, halo planes)
        ((8, 100, 154, 72, 256, 5), (8, 2, 8, 3)),  # the remat layers 1-3
        ((8, 100, 154, 96, 128, 3), (4, 1, 33, 5)),
        ((8, 100, 154, 48, 64, 3), (1, 1, 130, 6)),
        ((8, 100, 154, 70, 256, 5), (8, 2, 8, 3)),  # config #3's layer 1, as Cin 72
        ((8, 100, 154, 64, 256, 5), (7, 2, 9, 3)),  # the hoisted layer 0's h
        ((384, 100, 154, 8, 256, 5), (1, 2, 66, 1)),  # the hoisted input conv
        ((8, 100, 154, 126, 256, 5), (13, 2, 5, 3)),  # config #2's layer 1
        ((8, 104, 158, 72, 256, 5), (8, 2, 8, 3)),  # the training tiles of the
        ((8, 54, 81, 72, 256, 5), (8, 2, 8, 3)),  # (1, 1), (2, 2), (2, 7)
        ((8, 54, 26, 72, 256, 5), (8, 2, 8, 3)),  # meshes, halo included
        ((8, 102, 156, 96, 128, 3), (4, 1, 33, 5)),
        ((8, 52, 79, 96, 128, 3), (4, 1, 32, 5)),
        ((8, 52, 24, 48, 64, 3), (1, 1, 112, 6)),
    ],
)
def test_dw_plan_at_the_main_path_shapes(shape, want):
    """The plan at the main paths' dW shapes: its row blocks, column
    blocks, slots and halo planes; one block per SM, the grid a whole wave
    of 132 SMs at least 95% full (or one pixel tile per block, where the
    frame has fewer tiles); two to four stages that fit shared memory."""
    p = _dw_plan(*shape)
    assert (p["rblocks"], p["n_tiles"], p["slots"], p["span"]) == want
    waves = _ceil(p["blocks"], SMS)
    assert p["blocks"] >= 0.95 * SMS * waves or p["per"] == 1
    assert waves == 1
    assert 2 <= p["ring"] <= RING and p["smem"] <= MAX_SMEM
    assert p["rblocks"] * p["octs"] >= p["octets"] > (p["rblocks"] - 1) * p["octs"]


# ---- B3's loop nest (csrc/conv_same.cu, conv_same_mma_kernel) --------------

CROWS, CCOLS, CCH = 8, 32, 16  # block tile, input channels per stage


def _pick_nt(cout, max_nt):
    best, best_width = 2, None
    for nt in range(2, max_nt + 1):
        width = _ceil(cout, 16 * nt) * 16 * nt
        if best_width is None or width <= best_width:
            best, best_width = nt, width
    return best


def _conv_kernel_emulation(x, w):
    """out as ``conv_same_mma_kernel`` computes it: operands padded by the
    wrapper (``_mma_operands``: channels and the weight pitch to multiples of
    8); per block (8 x 32 pixels, one slice of 16*NT output channels) and
    16-channel chunk one stage holding the halo (zero outside the frame and
    past Cin) and the weights of every tap (zero past Cin and past the
    pitch); tap (dy, dx) reads the halo shifted by (dy, dx); only pixels in
    the frame and channels below Cout are stored, each once."""
    B, H, W, _ = x.shape
    k, cout = w.shape[0], w.shape[-1]
    x, w = convgrad._mma_operands(x, w)
    cin, cw = x.shape[-1], w.shape[-1]
    assert cin % 8 == 0 and cw % 8 == 0 and cw - cout < 8
    P = k // 2
    tn = 16 * _pick_nt(cout, 5 if k <= 5 else 3)
    x, w = x.float(), w.float().reshape(k * k, cin, cw)
    hr, hc = CROWS + k - 1, CCOLS + k - 1
    out = torch.full((B, H, W, cout), float("nan"))
    writes = torch.zeros((B, H, W, cout), dtype=torch.int32)
    for b in range(B):
        for n0 in range(0, cout, tn):
            for row0 in range(0, H, CROWS):
                for col0 in range(0, W, CCOLS):
                    acc = torch.zeros((CROWS, CCOLS, tn))
                    for c0 in range(0, cin, CCH):
                        halo = torch.zeros((hr, hc, CCH))
                        ys = slice(max(0, row0 - P), min(H, row0 - P + hr))
                        xs = slice(max(0, col0 - P), min(W, col0 - P + hc))
                        cs = min(CCH, cin - c0)
                        halo[ys.start - (row0 - P) : ys.stop - (row0 - P),
                             xs.start - (col0 - P) : xs.stop - (col0 - P), :cs] = \
                            x[b, ys, xs, c0 : c0 + cs]
                        wt = torch.zeros((k * k, CCH, tn))
                        ns = max(0, min(tn, cw - n0))
                        wt[:, :cs, :ns] = w[:, c0 : c0 + cs, n0 : n0 + ns]
                        for tap in range(k * k):
                            dy, dx = divmod(tap, k)
                            acc += halo[dy : dy + CROWS, dx : dx + CCOLS] @ wt[tap]
                    rs, cl = min(CROWS, H - row0), min(CCOLS, W - col0)
                    ns = min(tn, cout - n0)
                    out[b, row0 : row0 + rs, col0 : col0 + cl, n0 : n0 + ns] = acc[:rs, :cl, :ns]
                    writes[b, row0 : row0 + rs, col0 : col0 + cl, n0 : n0 + ns] += 1
    return out, writes


@pytest.mark.parametrize(
    "B,H,W,cin,cout,k",
    [(1, 11, 37, 40, 70, 5),  # config #3's Cout 70: one 80-wide slice
     (2, 9, 33, 22, 126, 3),  # ragged Cin (padded by the wrapper), two slices
     (1, 10, 20, 16, 30, 7)],  # k 7: the narrower slices that fit two stages
)
def test_conv_same_kernel_loop_nest_matches_plain(B, H, W, cin, cout, k):
    """The emulated B3 kernel equals ``conv_same_plain`` to f32 rounding
    (1e-5 of the largest entry) and writes every output exactly once."""
    x = _t(_randn(30, B, H, W, cin))
    w = _t(_randn(31, k, k, cin, cout, scale=0.1))
    got, writes = _conv_kernel_emulation(x, w)
    assert (writes == 1).all()
    assert _rel(got.numpy(), convgrad.conv_same_plain(x, w).numpy()) <= 1e-5


def test_mma_operands_pad_to_whole_groups_and_keep_the_conv():
    """The wrapper's padding for the bf16 kernel: channels and the weight
    pitch rounded up to multiples of 8 with zeros, 16-byte aligned, and the
    same conv on the first Cout channels (to f32 rounding); aligned whole
    groups are not copied."""
    x = _t(_randn(40, 1, 6, 9, 62), torch.bfloat16)
    w = _t(_randn(41, 3, 3, 62, 70, scale=0.1), torch.bfloat16)
    xp, wp = convgrad._mma_operands(x, w)
    assert xp.shape == (1, 6, 9, 64) and wp.shape == (3, 3, 64, 72)
    assert xp.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0
    assert not xp[..., 62:].any() and not wp[:, :, 62:].any() and not wp[..., 70:].any()
    # the zero channels add nothing; the CPU conv groups its f32 sums by the
    # channel count, so the two agree to f32 rounding
    torch.testing.assert_close(convgrad.conv_same_plain(xp, wp)[..., :70],
                               convgrad.conv_same_plain(x, w), atol=1e-5, rtol=0)
    xa, wa = _t(_randn(42, 1, 4, 5, 16), torch.bfloat16), _t(_randn(43, 3, 3, 16, 24))
    xs, ws = convgrad._mma_operands(xa, wa)
    assert xs is xa and ws is wa


# ---- the rollout's device ---------------------------------------------------


def _meta_setup():
    cfg = ConvLSTMConfig(in_channels=3, hidden_channels=(4, 4), kernel_sizes=(3, 3))
    params = convlstm_init(torch.Generator().manual_seed(0), cfg)
    meta = {"cells": [{k: v.to("meta") for k, v in c.items()} for c in params["cells"]],
            "head": {k: v.to("meta") for k, v in params["head"].items()}}
    norm = Normalizer(np.zeros(3, np.float32), np.ones(3, np.float32), 0.0, 1.0)
    return cfg, meta, norm, _randn(50, 1, 2, 3, 8, 12)


def test_rollout_runs_on_the_parameters_device():
    """``make_rollout_fn`` with ``device=None`` runs where the parameters
    are, not where numpy forcings would land (the CPU): parameters on the
    meta device (a stand-in for a card) give meta predictions and carry,
    where the forcings used to stay on the CPU and fail the cell's
    one-device check."""
    cfg, meta, norm, forcings = _meta_setup()
    geo = dict(padded_shape=(10, 14), grid_shape=(8, 12))
    preds, state = make_rollout_fn(cfg, norm, **geo)(meta, forcings)
    assert preds.device.type == "meta" and tuple(preds.shape) == (1, 2, 8, 12)
    assert all(h.device.type == "meta" and c.device.type == "meta" for h, c in state)
    step = make_streaming_rollout(cfg, norm, meta, **geo)
    out = step(forcings[:, 0])
    assert out.device.type == "meta" and tuple(out.shape) == (1, 8, 12)
    # an explicit device still wins
    with pytest.raises(ValueError):
        make_rollout_fn(cfg, norm, device="cpu", **geo)(meta, forcings)


def test_rollout_device_default_keeps_cpu_results():
    """On the CPU nothing changes: the default device and an explicit
    ``device="cpu"`` give the same predictions."""
    cfg = ConvLSTMConfig(in_channels=3, hidden_channels=(4, 4), kernel_sizes=(3, 3))
    params = convlstm_init(torch.Generator().manual_seed(1), cfg)
    norm = Normalizer(np.zeros(3, np.float32), np.ones(3, np.float32), 0.0, 1.0)
    forcings = _randn(51, 1, 3, 3, 8, 12)
    geo = dict(padded_shape=(10, 14), grid_shape=(8, 12))
    a, _ = make_rollout_fn(cfg, norm, **geo)(params, forcings)
    b, _ = make_rollout_fn(cfg, norm, device="cpu", **geo)(params, forcings)
    assert a.device.type == "cpu"
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert math.isfinite(a.abs().max().item())
