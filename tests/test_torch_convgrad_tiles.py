"""The weight gradient (B2's dW, ``conv_dw``) and the SAME conv (B3,
``conv_same``) of the PyTorch port at ragged channel counts, against the JAX
package, plus emulations of the two tensor-core kernels' loop nests.

* The plain versions (what the CPU runs) against the JAX package: ``conv_dw``
  against ``_conv_grads`` (the XLA weight gradient of the JAX per-cell
  route), ``conv_same`` against ``conv_same_v2`` and ``fused_cell_bwd``
  against ``fused_cell_bwd_v2``, both in Pallas interpret mode.
* A torch emulation of each kernel's loop nest (``csrc/cell_bwd.cu``
  ``dw_mma_kernel`` and ``csrc/conv_same.cu`` ``conv_same_mma_kernel``):
  their plans, pixel tiles, haloes, tap offsets, zero-filled channel groups,
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


# ---- the dW kernel's loop nest (csrc/cell_bwd.cu, dw_mma_kernel) -----------

ROWS, COLS, CH = 8, 16, 16  # pixel tile, channels per block
WARPS, TARGET_BLOCKS, MAX_SLOTS, TAPS_PER_WARP = 16, 264, 128, 4


def _ceil(a, b):
    return -(-a // b)


def _dw_plan(B, H, W, cin, n, k):
    """``plan_dw`` for bf16: warps along the columns, taps per block, block
    counts and the fixed slot split of the pixel tiles."""
    nj = 1 if n <= 32 else (4 if k <= 3 and n > 64 else 2)
    cp, np_ = _ceil(cin, 8) * 8, _ceil(n, 8) * 8
    taps = min(k * k, (WARPS // nj) * TAPS_PER_WARP)
    plan = dict(nj=nj, cp=cp, np=np_, taps=taps, tn=32 * nj,
                cblocks=_ceil(cp, CH), tblocks=_ceil(k * k, taps),
                n_tiles=_ceil(n, 32 * nj), tiles_w=_ceil(W, COLS), tiles_h=_ceil(H, ROWS))
    plan["tiles"] = B * plan["tiles_h"] * plan["tiles_w"]
    outs = plan["cblocks"] * plan["tblocks"] * plan["n_tiles"]
    slots = max(1, min(MAX_SLOTS, TARGET_BLOCKS // outs))
    plan["per"] = _ceil(plan["tiles"], slots)
    plan["slots"] = _ceil(plan["tiles"], plan["per"])
    return plan


def _dw_kernel_emulation(x, g, k):
    """dw as ``dw_mma_kernel`` computes it: xh and dgates zero-padded to whole
    8-channel groups (``pad_channels_kernel``); per slot and block (16
    channels x its taps x its columns) the slot's 8 x 16 pixel tiles, each
    staged as its xh halo (zero outside the frame and past the padded
    channels) and its dgates rows (zero past the frame); tap (dy, dx) reads
    the halo shifted by (dy, dx); partials per slot, rows past Cin never
    written; then the slots summed in order.  Returns (dw, plan, writes),
    writes counting how often each dw entry was written per slot."""
    B, H, W, cin = x.shape
    n = g.shape[-1]
    p = _dw_plan(B, H, W, cin, n, k)
    P = k // 2
    x = torch.nn.functional.pad(x.float(), (0, p["cp"] - cin))
    g = torch.nn.functional.pad(g.float(), (0, p["np"] - n))
    hr, hc = ROWS + k - 1, COLS + k - 1
    part = torch.zeros((p["slots"], k * k, cin, n))
    writes = torch.zeros((p["slots"], k * k, cin, n), dtype=torch.int32)
    for slot in range(p["slots"]):
        tile_ids = range(slot * p["per"], min(p["tiles"], (slot + 1) * p["per"]))
        for cb in range(p["cblocks"]):
            c0 = cb * CH
            halos, gts = [], []
            for t in tile_ids:
                tx, t2 = t % p["tiles_w"], t // p["tiles_w"]
                ty, b = t2 % p["tiles_h"], t2 // p["tiles_h"]
                y0, x0 = ty * ROWS, tx * COLS
                halo = torch.zeros((hr, hc, CH))
                for r in range(hr):
                    y = y0 - P + r
                    if not 0 <= y < H:
                        continue
                    lo, hi = max(0, x0 - P), min(W, x0 - P + hc)
                    for grp in range(2):  # two 8-channel groups, zero past cp
                        ch = c0 + 8 * grp
                        if ch < p["cp"]:
                            halo[r, lo - (x0 - P) : hi - (x0 - P), 8 * grp : 8 * grp + 8] = \
                                x[b, y, lo:hi, ch : ch + 8]
                gt = torch.zeros((ROWS, COLS, p["n_tiles"] * p["tn"]))
                ys, xs = slice(y0, min(H, y0 + ROWS)), slice(x0, min(W, x0 + COLS))
                gt[: ys.stop - y0, : xs.stop - x0, : p["np"]] = g[b, ys, xs]
                halos.append(halo)
                gts.append(gt)
            halos, gts = torch.stack(halos), torch.stack(gts)
            for tb in range(p["tblocks"]):
                t0 = tb * p["taps"]
                for tap in range(t0, min(k * k, t0 + p["taps"])):
                    dy, dx = divmod(tap, k)
                    a = halos[:, dy : dy + ROWS, dx : dx + COLS]  # (tiles, 8, 16, 16 ch)
                    acc = torch.einsum("trpc,trpn->cn", a, gts)
                    for nb in range(p["n_tiles"]):
                        n0 = nb * p["tn"]
                        cs, ns = min(CH, cin - c0), min(p["tn"], n - n0)
                        if cs > 0:
                            part[slot, tap, c0 : c0 + cs, n0 : n0 + ns] = acc[:cs, n0 : n0 + ns]
                            writes[slot, tap, c0 : c0 + cs, n0 : n0 + ns] += 1
    dw = part[0].clone()
    for s in range(1, p["slots"]):  # sum_slots_kernel: slots in order
        dw = dw + part[s]
    return dw.reshape(k, k, cin, n), p, writes


@pytest.mark.parametrize(
    "B,H,W,cin,n,k",
    [(2, 9, 37, 22, 40, 5),  # ragged rows, columns and channels; 2 warps along N
     (1, 11, 19, 6, 96, 3),  # Cin 6: one zero-filled group; 4 warps along N
     (1, 6, 17, 40, 40, 7)],  # k 7 splits its 49 taps (32 + 17); 3 channel blocks
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


def test_dw_plan_at_the_main_path_shapes():
    """The slot split of the main path's dW shapes: two waves of 132 blocks
    or fewer, and config #3's Cin 70 blocked like Cin 72 (5 channel blocks,
    one zero-filled group)."""
    shapes = {  # (B, H, W, Cin, N, k): (channel blocks, column tiles, slots)
        (8, 100, 154, 72, 256, 5): (5, 4, 13),
        (8, 100, 154, 70, 256, 5): (5, 4, 13),
        (8, 100, 154, 96, 128, 3): (6, 1, 44),
        (8, 100, 154, 48, 64, 3): (3, 1, 87),
        (8, 100, 154, 64, 256, 5): (4, 4, 16),
        (384, 100, 154, 8, 256, 5): (1, 4, 66),
    }
    for shape, want in shapes.items():
        p = _dw_plan(*shape)
        assert (p["cblocks"], p["n_tiles"], p["slots"]) == want, shape
        assert p["cblocks"] * p["tblocks"] * p["n_tiles"] * p["slots"] <= TARGET_BLOCKS


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
