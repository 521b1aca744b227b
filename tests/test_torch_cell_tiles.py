"""The gate-conv mainloop of the PyTorch port's cell kernels (every mode of
B1 and B2's gate recompute, ``csrc/cell_mainloop.cuh`` ``cell_wgmma_kernel``)
emulated index by index in torch, against the plain versions and the JAX
package.

* The plan (``plan_cell``): tile grid, halo copy width, channel
  padding, K steps, ring and shared memory at every main-path shape.
* The weight packing (``pack_cell_weights_kernel``) and its inverse, and the
  kernel's per-unit index math.
* The loop nest: 8 x 16 pixel tiles, the haloed tile staged per 128-channel
  group with zeros outside the frame and past Cin, K in 16-channel steps
  over every tap, the weight ring filled stage by stage under its barrier protocol, B
  read through the descriptor's strides, the accumulator's register layout
  and the epilogue's gate mapping, and the fixed-order db partial sums; against
  ``fused_cell_forward_plain`` / ``fused_cell_bwd_plain`` and, at ragged
  Cin, against ``fused_cell_forward_v2`` / ``fused_cell_bwd_v2`` (Pallas
  interpret mode).  The kernel itself runs only on a card
  (``tests/test_torch_cuda.py``).
* The two-part stage (``stage_parts``, B1's plain mode reading x and h
  where they lie): each part's route, its scratch within the shared memory
  the launch may take, and the halo it stages, byte for byte the one
  ``stage_halo`` stages from the concatenated, cast xh; the layouts it
  refuses, which the caller concatenates; the pair through
  ``fused_cell_forward`` and ``cells_step`` on the CPU, with and without
  grad.

Inputs are seeded numpy; shapes are small."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.ops import convgrad_pallas as jcg  # noqa: E402
from nasa_niswan_tpu.ops import convlstm_pallas2 as jv2  # noqa: E402
from nasa_niswan_tpu_torch.ops.convgrad import (  # noqa: E402
    cell_bwd_recompute,
    fused_cell_bwd,
    fused_cell_bwd_plain,
)
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    elementwise_bwd,
    fused_cell_gates_plain,
    gate_update,
)

ROWS, COLS = 8, 16  # pixel tile: 8 consumer warps of one 16-pixel row each
GROUP_CH, RING, STAGE_BYTES, RING_OFFSET = 128, 4, 16384, 128
LBO, SBO = 128, 256  # bytes between core matrices along K, along N
MAX_SMEM = 232448


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ceil(a, b):
    return -(-a // b)


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _bf(a):
    """f32 values rounded to bf16: the kernel's operands, exact in f32."""
    return _t(a).bfloat16().float()


# ---- the plan ----------------------------------------------------------------


def _chunks(cin, g):
    return _ceil(min(GROUP_CH, cin - g * GROUP_CH), 16)


def _plan(B, H, W, cin, hid, k, align=16):
    """``plan_cell`` for bf16 at hid 8/16/32/64: grid (x, y, z), halo copy
    width (channels), padded group width, steps, steps per stage, ring
    stages, shared memory and the packed weights' bf16 count."""
    n = 4 * hid
    vec = next(v for v in (8, 4, 2, 1) if cin % v == 0 and align % (2 * v) == 0)
    cp = _ceil(min(cin, GROUP_CH), 16) * 16
    steps = sum(k * k * _chunks(cin, g) for g in range(_ceil(cin, GROUP_CH)))
    ks = STAGE_BYTES // (n * 32)
    ring = min(RING, _ceil(steps, ks))
    halo = (ROWS + k - 1) * (COLS + k - 1) * (cp + 8) * 2
    return dict(grid=(_ceil(W, COLS), _ceil(H, ROWS), B),
                vec=vec, cp=cp, steps=steps, ks=ks, ring=ring, n=n,
                smem=RING_OFFSET + ring * ks * n * 32 + halo, pack_elems=steps * n * 16)


# (B, H, W, Cin, hid, k): serving layers 1-3 and the hoisted h-conv (B = 1);
# training layers 1-3, config #3's layer 1 and the hoisted layer 0 (B = 8)
MAIN_SHAPES = {
    (1, 100, 154, 126, 64, 5): dict(vec=2, cp=128, steps=200, ring=4, blocks=130),
    (1, 100, 154, 96, 32, 3): dict(vec=8, cp=96, steps=54, ring=4, blocks=130),
    (1, 100, 154, 48, 16, 3): dict(vec=8, cp=48, steps=27, ring=4, blocks=130),
    (1, 100, 154, 64, 64, 5): dict(vec=8, cp=64, steps=100, ring=4, blocks=130),
    (8, 100, 154, 72, 64, 5): dict(vec=8, cp=80, steps=125, ring=4, blocks=1040),
    (8, 100, 154, 96, 32, 3): dict(vec=8, cp=96, steps=54, ring=4, blocks=1040),
    (8, 100, 154, 48, 16, 3): dict(vec=8, cp=48, steps=27, ring=4, blocks=1040),
    (8, 100, 154, 70, 64, 5): dict(vec=2, cp=80, steps=125, ring=4, blocks=1040),
    (8, 100, 154, 64, 64, 5): dict(vec=8, cp=64, steps=100, ring=4, blocks=1040),
}


@pytest.mark.parametrize("shape", list(MAIN_SHAPES))
def test_plan_at_the_main_path_shapes(shape):
    """Every bf16 main-path shape: 10 x 13 tiles a frame, whole 16-channel
    steps (Cin 126 costs Cin 128's 200 steps), 4 ring stages of 16 KB,
    shared memory within the card's 227 KB, and the weight bytes fetched
    from L2 per launch (blocks x packed bytes): at hid 64 within the
    channel padding (80/72, 128/126) of the old mma.sync kernel's, and at
    most 55% of them at hid 32 and 16, whose blocks now hold 8 rows, not 4."""
    want = MAIN_SHAPES[shape]
    B, H, W, cin, hid, k = shape
    p = _plan(*shape)
    blocks = p["grid"][0] * p["grid"][1] * p["grid"][2]
    got = dict(vec=p["vec"], cp=p["cp"], steps=p["steps"], ring=p["ring"], blocks=blocks)
    assert got == want
    assert p["grid"][:2] == (10, 13) and p["smem"] <= MAX_SMEM
    assert p["steps"] * 16 == k * k * p["cp"] and p["cp"] - cin < 16
    fetched = blocks * p["pack_elems"] * 2
    # the old kernel: 8-row blocks at hid 64 (4 rows below), each reading
    # the k*k*Cin*N bf16 weights
    old_rows = 8 if hid == 64 else 4
    old = B * 10 * _ceil(H, old_rows) * k * k * cin * 4 * hid * 2
    assert fetched <= (p["cp"] / cin if hid == 64 else 0.55) * old


# ---- the weight packing ------------------------------------------------------


def _step_of(s, cin, k):
    """(group, tap, chunk) of K step s, as the pack kernel derives them."""
    g = s // (k * k * (GROUP_CH // 16))
    rem = s - g * k * k * (GROUP_CH // 16)
    nch = _chunks(cin, g)
    return g, rem // nch, rem % nch


def _pack(w):
    """w (k,k,Cin,N) -> the packed image (steps * N * 16,): per step the k16
    x N tile [N/8][2][8][8] (8 columns x 8 channels per 128-byte core
    matrix), channels past Cin zero."""
    k, _, cin, n = w.shape
    steps = _plan(1, 1, 1, cin, n // 4, k)["steps"]
    wf = w.reshape(k * k, cin, n)
    out = torch.empty(steps * n * 16, dtype=w.dtype)
    for s in range(steps):
        g, tap, c = _step_of(s, cin, k)
        ch0 = g * GROUP_CH + 16 * c
        tile = torch.zeros(16, n, dtype=w.dtype)
        valid = min(16, cin - ch0)
        tile[:valid] = wf[tap, ch0 : ch0 + valid]
        # (kh, e, nb, r) -> (nb, kh, r, e)
        out[s * n * 16 : (s + 1) * n * 16] = tile.reshape(2, 8, n // 8, 8).permute(2, 0, 3, 1).reshape(-1)
    return out


def _b_tile(flat, base, n):
    """The k16 x N B operand that wgmma reads from element offset ``base``
    of ``flat`` through the descriptor: K-major, unswizzled, 16-byte rows of
    8 channels, core matrices LBO apart along K and SBO apart along N."""
    kk = torch.arange(16)[:, None]
    nn = torch.arange(n)[None, :]
    idx = base + (nn // 8) * (SBO // 2) + (kk // 8) * (LBO // 2) + (nn % 8) * 8 + kk % 8
    return flat[idx]


def _unpack(flat, k, cin, n):
    """The inverse of ``_pack``: w (k,k,Cin,N) back from the B tiles."""
    steps = _plan(1, 1, 1, cin, n // 4, k)["steps"]
    w = torch.zeros(k * k, cin, n, dtype=flat.dtype)
    for s in range(steps):
        g, tap, c = _step_of(s, cin, k)
        ch0 = g * GROUP_CH + 16 * c
        tile = _b_tile(flat, s * n * 16, n)
        valid = min(16, cin - ch0)
        w[tap, ch0 : ch0 + valid] = tile[:valid]
        assert not tile[valid:].any()
    return w.reshape(k, k, cin, n)


@pytest.mark.parametrize("cin,hid,k", [(13, 8, 3), (70, 64, 5), (126, 16, 1), (200, 32, 3)])
def test_pack_round_trips(cin, hid, k):
    """pack then read back through the descriptor's strides gives w exactly
    (bf16), with zero rows past Cin; Cin 200 spans two channel groups."""
    w = _t(_randn(1, k, k, cin, 4 * hid), torch.bfloat16)
    flat = _pack(w)
    assert flat.numel() == _plan(1, 1, 1, cin, hid, k)["pack_elems"]
    assert torch.equal(_unpack(flat, k, cin, 4 * hid), w)


def test_pack_kernel_index_math():
    """Each 16-byte unit u of the kernel's output holds the 8 channels
    ch0..ch0+7 of column n that its integer arithmetic names."""
    k, cin, hid = 3, 150, 8
    n = 4 * hid
    w = _t(_randn(2, k, k, cin, n), torch.bfloat16)
    flat = _pack(w).reshape(-1, 8)
    wf = torch.nn.functional.pad(w.reshape(k * k, cin, n), (0, 0, 0, 16))
    for u in range(0, flat.shape[0], 7):
        r, kh, t = u & 7, (u >> 3) & 1, u >> 4
        nb, s = t % (n // 8), t // (n // 8)
        g, tap, c = _step_of(s, cin, k)
        ch0 = g * GROUP_CH + 16 * c + 8 * kh
        want = wf[tap, ch0 : ch0 + 8, 8 * nb + r].clone()
        want[max(0, cin - ch0):] = 0
        assert torch.equal(flat[u], want), u


# ---- the loop nest ----------------------------------------------------------


def _registers(tile, n):
    """The wgmma accumulator as registers: tile (..., 16 pixels, N) of each
    warp -> (..., 32 lanes, N/2), register 4i + 2h + e of lane (grp, q)
    holding pixel grp + 8h, column 8i + 2q + e."""
    regs = torch.empty(*tile.shape[:-2], 32, n // 2)
    for lane in range(32):
        grp, q = lane >> 2, lane & 3
        for h in range(2):
            for e in range(2):
                regs[..., lane, 2 * h + e :: 4] = tile[..., grp + 8 * h, 2 * q + e :: 8]
    return regs


def _epilogue_gates(regs, hid):
    """The epilogue's reading of the registers: channels j, j + 1 = 8i + 2q
    + {0, 1} of pixel grp + 8h, gate g from register 4(i + g*hid/8) + 2h + e.
    Returns (..., 16 pixels, 4, hid) and how often each entry was read."""
    nt = hid // 8
    gates = torch.full((*regs.shape[:-2], 16, 4, hid), float("nan"))
    reads = torch.zeros((16, 4, hid), dtype=torch.int32)
    for lane in range(32):
        grp, q = lane >> 2, lane & 3
        for i in range(nt):
            j = 8 * i + 2 * q
            for h in range(2):
                for gt in range(4):
                    for e in range(2):
                        gates[..., grp + 8 * h, gt, j + e] = regs[..., lane, 4 * (i + gt * nt) + 2 * h + e]
                        reads[grp + 8 * h, gt, j + e] += 1
    return gates, reads


@pytest.mark.parametrize("hid", [8, 16, 32, 64])
def test_epilogue_gate_mapping(hid):
    """Block-order columns (gate g of channel j at g*hid + j) in the wgmma
    accumulator layout: every lane holds all four gates of its channels, and
    the epilogue reads each (pixel, gate, channel) exactly once."""
    n = 4 * hid
    tile = _t(_randn(3, 8, 16, n))
    gates, reads = _epilogue_gates(_registers(tile, n), hid)
    assert (reads == 1).all()
    assert torch.equal(gates, tile.reshape(8, 16, 4, hid))


def _mainloop(xh, w, k, plan):
    """The f32 gate sums of ``cell_wgmma_kernel``'s mainloop over the padded
    tile grid: (B, rows, columns, N), rows and columns whole tiles.  Per
    128-channel group every block stages its halo (zero outside the frame
    and past Cin, channels padded to cp); each K step reads A at the
    tap-shifted halo address and B from the ring slot the producer filled
    with the stage's bytes."""
    B, H, W, cin = xh.shape
    n, ks = plan["n"], plan["ks"]
    gx, gy = plan["grid"][0], plan["grid"][1]
    P = k // 2
    hr, hc = ROWS + k - 1, COLS + k - 1
    flat = _pack(w)
    stage = ks * n * 16
    ring = torch.zeros(plan["ring"] * stage)
    acc = torch.zeros(B, gy, gx, ROWS, COLS, n)
    s = 0
    for g in range(_ceil(cin, GROUP_CH)):
        c0 = g * GROUP_CH
        cend = min(cin, c0 + GROUP_CH)
        img = torch.zeros(B, gy * ROWS + k - 1, gx * COLS + k - 1, plan["cp"])
        img[:, P : P + H, P : P + W, : cend - c0] = xh[..., c0:cend]
        halos = torch.stack([torch.stack([img[:, by * ROWS : by * ROWS + hr,
                                              bx * COLS : bx * COLS + hc]
                                          for bx in range(gx)], 1)
                             for by in range(gy)], 1)  # (B, gy, gx, hr, hc, cp)
        for tap in range(k * k):
            dy, dx = divmod(tap, k)
            for c in range(_chunks(cin, g)):
                st, inn = divmod(s, ks)
                slot = st % plan["ring"]
                if inn == 0:  # the stage lands in its slot
                    size = min(ks, plan["steps"] - st * ks) * n * 16
                    ring[slot * stage : slot * stage + size] = flat[st * stage : st * stage + size]
                a = halos[:, :, :, dy : dy + ROWS, dx : dx + COLS, 16 * c : 16 * c + 16]
                acc += a @ _b_tile(ring, slot * stage + inn * n * 16, n)
                s += 1
    assert s == plan["steps"]
    return acc.permute(0, 1, 3, 2, 4, 5).reshape(B, gy * ROWS, gx * COLS, n)


def _block_gates(acc, hid):
    """Every block's accumulator through the register layout and the
    epilogue's mapping: (B, rows, columns, 4*hid) in block order."""
    B, R, C, n = acc.shape
    tiles = acc.reshape(B, R // ROWS, ROWS, C // COLS, COLS, n).permute(0, 1, 3, 2, 4, 5)
    out = _epilogue_gates(_registers(tiles, n), hid)[0]
    out = out.reshape(B, R // ROWS, C // COLS, ROWS, COLS, n).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, R, C, n)


def _emulate_forward(xh, c, w, b, xg=None):
    """B1 in its emit_gates mode as the kernel computes it: (h', c', the f32
    gates) on the frame, from bf16-valued f32 operands."""
    B, H, W, cin = xh.shape
    hid, k = c.shape[-1], w.shape[0]
    plan = _plan(B, H, W, cin, hid, k)
    gates = _block_gates(_mainloop(xh, w, k, plan), hid)[:, :H, :W] + b
    if xg is not None:
        gates = gates + xg
    h_new, c_new = gate_update(gates, c)
    return h_new, c_new, gates


FWD_SHAPES = [
    (2, 11, 37, 13, 16, 5),  # odd Cin (2-byte halo copies), ragged rows and columns
    (1, 9, 20, 70, 64, 7),  # config #3's Cin 70 (4-byte copies), k 7
    (1, 10, 33, 126, 64, 5),  # the serving layer 1's Cin 126, a partial column tile
    (2, 8, 16, 48, 16, 3),  # one whole tile per frame
    (1, 12, 18, 72, 32, 1),  # k 1
    (2, 9, 17, 200, 8, 3),  # two channel groups (128 + 72)
]


@pytest.mark.parametrize("B,H,W,cin,hid,k", FWD_SHAPES)
def test_forward_loop_nest_matches_plain(B, H, W, cin, hid, k):
    """The emulated kernel (B1, emit_gates mode with hoisted gates where the
    shape has hid 16) equals the plain version to f32 rounding: h', c' 1e-5
    and the f32 gates 1e-5 of their largest entry."""
    xh, c = _bf(_randn(10, B, H, W, cin)), _t(_randn(11, B, H, W, hid))
    w = _bf(_randn(12, k, k, cin, 4 * hid, scale=(k * k * cin) ** -0.5))
    b = _t(_randn(13, 4 * hid, scale=0.1))
    xg = _bf(_randn(14, B, H, W, 4 * hid)) if hid == 16 else None
    got = _emulate_forward(xh, c, w, b, xg)
    want = fused_cell_gates_plain(xh, c, w, b, xg)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    ref = (torch.nn.functional.conv2d(xh.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                      padding=k // 2).permute(0, 2, 3, 1) + b)
    if xg is not None:
        ref = ref + xg
    assert (got[2] - ref).abs().max() <= 1e-5 * ref.abs().max()


def _butterfly(v):
    """__shfl_xor over lane bits 2, 3, 4 (grp bits 0, 1, 2) in that order:
    v (..., 8 grp) -> the sum every grp ends with, taken at grp 0."""
    for m in (1, 2, 4):
        v = v + v[..., [g ^ m for g in range(8)]]
    return v[..., 0]


def _db_in_order(d, H, W, plan):
    """db as the kernel and sum_rows_kernel sum it: per thread its two
    pixels (h = 0, 1, out-of-frame ones skipped), the butterfly over grp,
    the 8 warps in order, one row per block; then each of 256 threads sums
    a strided run of rows, and a fixed tree sums the threads."""
    B, R, C, n = d.shape
    d = d.clone()
    d[:, H:] = 0
    d[:, :, W:] = 0
    tiles = d.reshape(B, R // ROWS, ROWS, C // COLS, 2, 8, n)  # (.., warp, .., h, grp, n)
    per_thread = tiles[..., 0, :, :] + tiles[..., 1, :, :]  # (B, gy, 8, gx, grp, n)
    warp = _butterfly(per_thread.movedim(-2, -1))  # (B, gy, 8, gx, n)
    rows = warp[:, :, 0]
    for cw in range(1, ROWS):
        rows = rows + warp[:, :, cw]
    rows = rows.reshape(-1, n)  # blocks in (b, y, x) order
    lanes = torch.zeros(256, n)
    for r in range(rows.shape[0]):
        lanes[r % 256] = lanes[r % 256] + rows[r]
    stride = 128
    while stride:
        lanes[:stride] = lanes[:stride] + lanes[stride : 2 * stride]
        stride //= 2
    return lanes[0]


BWD_SHAPES = [
    (2, 11, 37, 13, 16, 5),
    (1, 10, 33, 126, 64, 5),
    (2, 9, 17, 72, 32, 3),
    (1, 12, 20, 48, 8, 7),
]


@pytest.mark.parametrize("B,H,W,cin,hid,k", BWD_SHAPES)
def test_backward_recompute_loop_nest_matches_plain(B, H, W, cin, hid, k):
    """B2 (a) emulated: the recomputed gates through the same mainloop, the
    elementwise backward, db in the kernel's fixed order; dgates (before
    rounding) and dc_prev 1e-5, db 1e-5 of its largest entry, against
    ``fused_cell_bwd_plain``; the block rows cover the padded grid."""
    xh, c = _bf(_randn(20, B, H, W, cin)), _t(_randn(21, B, H, W, hid))
    dh, dc = _t(_randn(22, B, H, W, hid)), _t(_randn(23, B, H, W, hid))
    w = _bf(_randn(24, k, k, cin, 4 * hid, scale=(k * k * cin) ** -0.5))
    b = _t(_randn(25, 4 * hid, scale=0.1))
    plan = _plan(B, H, W, cin, hid, k)
    gates = _block_gates(_mainloop(xh, w, k, plan), hid) + b
    R, C = gates.shape[1:3]
    cpad = torch.nn.functional.pad(c, (0, 0, 0, C - W, 0, R - H))
    dhp = torch.nn.functional.pad(dh, (0, 0, 0, C - W, 0, R - H))
    dcp = torch.nn.functional.pad(dc, (0, 0, 0, C - W, 0, R - H))
    dgates, dc_prev = elementwise_bwd(gates, cpad, dhp, dcp)
    db = _db_in_order(dgates, H, W, plan)
    want = fused_cell_bwd_plain(xh, c, dh, dc, w, b)
    want32, _ = elementwise_bwd(
        torch.nn.functional.conv2d(xh.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                   padding=k // 2).permute(0, 2, 3, 1) + b, c, dh, dc)
    torch.testing.assert_close(dgates[:, :H, :W], want32, atol=1e-5, rtol=0)
    torch.testing.assert_close(dc_prev[:, :H, :W], want[1], atol=1e-5, rtol=0)
    assert (db - want[3]).abs().max() <= 1e-5 * want[3].abs().max()


# ---- ragged Cin against the JAX package (Pallas interpret mode) --------------


def _margin(a, o, wp, dtype=jnp.float32):
    return jv2.pad_cols(jnp.asarray(a, dtype), o, wp)


@pytest.mark.parametrize("B,H,W,cin,hid,k", [(1, 16, 20, 70, 8, 3), (1, 16, 24, 13, 16, 5)])
def test_forward_loop_nest_matches_jax_at_ragged_cin(B, H, W, cin, hid, k):
    """The emulated kernel against ``fused_cell_forward_v2`` (emit_gates,
    interpret mode) on the same bf16 operands: h', c' 1e-5; the gates,
    which JAX rounds to bf16, within one bf16 step plus 1e-5."""
    xh, c = _randn(30, B, H, W, cin), _randn(31, B, H, W, hid)
    w = _randn(32, k, k, cin, 4 * hid, scale=(k * k * cin) ** -0.5)
    b = _randn(33, 4 * hid, scale=0.1)
    o = max(k // 2, 1)
    wp = jv2.padded_cols(W, o)
    bf = jnp.bfloat16
    want = jv2.fused_cell_forward_v2(
        _margin(xh, o, wp, bf), _margin(c, o, wp), jnp.asarray(w, bf), jnp.asarray(b),
        k, o, W, interpret=True, emit_gates=True)
    got = _emulate_forward(_bf(xh), _t(c), _bf(w), _t(b))
    crop = lambda a: np.asarray(jnp.asarray(a, jnp.float32))[:, :, o : o + W]  # noqa: E731
    np.testing.assert_allclose(got[0].numpy(), crop(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), crop(want[1]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), crop(want[2]), rtol=2.0**-7, atol=1e-5)


def test_backward_recompute_matches_jax_at_ragged_cin():
    """B2 (a) emulated at Cin 70 against ``fused_cell_bwd_v2`` (interpret
    mode, bf16 operands): dgates within one bf16 step plus 1e-5, dc_prev
    2e-5, db 2e-4 (the sums of ~200 f32 cotangents in another order)."""
    B, H, W, cin, hid, k = 1, 12, 18, 70, 8, 3
    xh, c, dh, dc = (_randn(40 + i, B, H, W, n) for i, n in enumerate((cin, hid, hid, hid)))
    w = _randn(44, k, k, cin, 4 * hid, scale=(k * k * cin) ** -0.5)
    b = _randn(45, 4 * hid, scale=0.1)
    o = k // 2
    wp = jv2.padded_cols(W, o)
    bf = jnp.bfloat16
    want = jcg.fused_cell_bwd_v2(
        _margin(xh, o, wp, bf), _margin(c, o, wp), _margin(dh, o, wp), _margin(dc, o, wp),
        jnp.asarray(w, bf), jnp.asarray(b), k, o, W, interpret=True)
    plan = _plan(B, H, W, cin, hid, k)
    gates = _block_gates(_mainloop(_bf(xh), _bf(w), k, plan), hid)[:, :H, :W] + _t(b)
    dgates, dc_prev = elementwise_bwd(gates, _t(c), _t(dh), _t(dc))
    sl = np.s_[:, :, o : o + W]
    np.testing.assert_allclose(dgates.bfloat16().float().numpy(),
                               np.asarray(want[0].astype(jnp.float32))[sl],
                               rtol=2.0**-7, atol=1e-5)
    np.testing.assert_allclose(dc_prev.numpy(), np.asarray(want[1])[sl], atol=2e-5)
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 16 * plan["grid"][0] - W,  # noqa: E731
                                                0, 8 * plan["grid"][1] - H))
    db = _db_in_order(pad(dgates), H, W, plan)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[3]), atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_bwd_recompute_is_b2_without_dw(dtype):
    """``cell_bwd_recompute`` (B2's part (a) alone, which the timing scripts
    call) gives exactly ``fused_cell_bwd``'s dgates, dc_prev and db."""
    B, H, W, cin, hid, k = 1, 7, 9, 13, 8, 3
    xh = _t(_randn(50, B, H, W, cin), dtype)
    c, dh, dc = (_t(_randn(51 + i, B, H, W, hid)) for i in range(3))
    w = _t(_randn(54, k, k, cin, 4 * hid, scale=0.2), dtype)
    b = _t(_randn(55, 4 * hid, scale=0.1))
    got = cell_bwd_recompute(xh, c, dh, dc, w, b)
    want = fused_cell_bwd(xh, c, dh, dc, w, b)
    for g, w_ in zip(got, (want[0], want[1], want[3])):
        assert torch.equal(g, w_)


def _ring_protocol(steps, ks, ring, n):
    """Play the weight ring's mbarrier protocol in order: the producer
    issues stage st once every consumer warp has released stage st - ring;
    the consumers wait for the full barrier of each stage they enter and
    release a stage once the step after its last has been issued (the
    wgmma of its last step is retired by that step's wait_group 1).
    Returns the
    order of events; raises on a deadlock or an overwrite of a stage still
    in use."""
    n_stages = _ceil(steps, ks)
    issued, released, done, in_use, events = 0, 0, 0, set(), []
    while done < steps:
        # the producers issue every stage the empty barriers allow
        while issued < n_stages and (issued < ring or released > issued - ring):
            slot = issued % ring
            assert slot not in in_use, f"stage {issued} overwrites slot {slot}"
            in_use.add(slot)
            events.append(("issue", issued))
            issued += 1
        need = done // ks  # the stage this step reads
        if need >= issued:
            raise RuntimeError(f"deadlock: step {done} needs stage {need}, "
                               f"{issued} issued, {released} released")
        done += 1
        while released < (done - 1) // ks:
            in_use.discard(released % ring)
            events.append(("release", released))
            released += 1
    # every stage lands once, in order, as whole 16-byte units
    assert [e[1] for e in events if e[0] == "issue"] == list(range(n_stages))
    for st in range(n_stages):
        assert min(ks, steps - st * ks) * n * 32 % 16 == 0
    return events


@pytest.mark.parametrize("shape", list(MAIN_SHAPES) + [(1, 9, 20, 70, 64, 7), (2, 9, 17, 200, 8, 3),
                                                      (1, 10, 12, 5, 8, 1)])
def test_weight_ring_protocol_never_stalls_or_overwrites(shape):
    """The producer and the consumer warps of every main-path plan (and a
    one-stage and a two-group shape) finish without a deadlock, and no
    stage is overwritten while a step may still read it."""
    p = _plan(*shape)
    events = _ring_protocol(p["steps"], p["ks"], p["ring"], p["n"])
    assert sum(e[0] == "release" for e in events) == (p["steps"] - 1) // p["ks"]


# ---- the two-part stage (B1's plain mode reading x and h where they lie) ------


def _dims(t):
    """A part's (batch, row, column, channel) strides as the kernel gets
    them: 0 for a dimension of size 1."""
    return tuple(s if n > 1 else 0 for n, s in zip(t.shape, t.stride()))


def _part_route(t, off):
    """``plan_part``: (route, copy width) of part ``t`` when its first
    channel is channel ``off`` of the input (storage 16-byte aligned, as the
    allocators give it), or None where it takes none."""
    sb, sy, sx, sc = _dims(t)
    ch = t.shape[-1]
    f32 = t.dtype == torch.float32
    esz = 4 if f32 else 2
    addr = t.storage_offset() * esz
    if sc == 1:
        vec = next((v for v in ((4, 2) if f32 else (8, 4, 2))
                    if ch % v == 0 and addr % (esz * v) == 0
                    and all(s_ % v == 0 for s_ in (sb, sy, sx)) and (f32 or off % v == 0)), 1)
        return None if not f32 and vec == 1 else ("f32" if f32 else "direct", vec)
    if not f32 and sx == 1 and sb % 2 == 0 and sy % 2 == 0 and sc % 2 == 0 and addr % 4 == 0:
        return "planes", 2
    return None


def _scratch_bytes(route, ch, k):
    hr, hc = ROWS + k - 1, COLS + k - 1
    n = {"f32": ch * hr * hc * 4, "planes": ch * hr * (hc + 2) * 2}.get(route, 0)
    return _ceil(n, 16) * 16


def _parts_plan(x, h, k, smem, budget=MAX_SMEM):
    """``plan_parts``: both parts' (route, copy width), their scratch
    offsets past the halo, and the launch's shared memory (``smem`` the
    plan's without the scratch), which may grow to ``budget``: past it the
    "f32" part of 4-float copies with the smaller scratch, then the other,
    goes to "regs".  None where a part takes no route or the scratch that
    remains does not fit."""
    routes = [_part_route(x, 0), _part_route(h, x.shape[-1])]
    if None in routes:
        return None
    routes = [list(r) for r in routes]
    chs = (x.shape[-1], h.shape[-1])
    while True:
        b0, b1 = (_scratch_bytes(r[0], c, k) for r, c in zip(routes, chs))
        if b0 + b1 == 0 or smem + b0 + b1 <= min(budget, MAX_SMEM):
            break
        r0, r1 = (r == ["f32", 4] for r in routes)
        if not (r0 or r1):
            return None
        routes[0 if r0 and (not r1 or b0 <= b1) else 1][0] = "regs"
    return [tuple(r) for r in routes], (0, b0), smem + b0 + b1


def _bits(t):
    """The bf16 bits (as int32) of every element of t's storage: an f32
    part rounded as ``.to(torch.bfloat16)`` (and ``__float2bfloat16``)
    round, to nearest even."""
    n = t.untyped_storage().nbytes() // t.element_size()
    flat = torch.as_strided(t, (n,), (1,), 0)
    return flat.to(torch.bfloat16).view(torch.int16).to(torch.int32)


def _stage_halo(xh, b, by, bx, g, k, vec, cp):
    """``stage_halo`` on the concatenated bf16 xh: the block's halo as bf16
    bits, -1 where nothing is written (the 8 channels of pixel padding)."""
    B, H, W, cin = xh.shape
    P, hc = k // 2, COLS + k - 1
    pix_n, ps = (ROWS + k - 1) * hc, cp + 8
    c0 = g * GROUP_CH
    cend = min(cin, c0 + GROUP_CH)
    bits = xh.contiguous().view(torch.int16).to(torch.int32)
    halo = torch.full((pix_n * ps,), -1, dtype=torch.int32)
    units = cp // vec
    e = torch.arange(pix_n * units)
    pix, u = e // units, e % units
    y, x = by * ROWS - P + pix // hc, bx * COLS - P + pix % hc
    for i in range(vec):
        ch = c0 + u * vec + i
        ok = (y >= 0) & (y < H) & (x >= 0) & (x < W) & (c0 + u * vec < cend)
        v = bits[b, y.clamp(0, H - 1), x.clamp(0, W - 1), ch.clamp(max=cin - 1)]
        halo[pix * ps + u * vec + i] = torch.where(ok, v, 0)
    return halo


def _stage_parts(parts, plan, H, W, b, by, bx, k, cp):
    """``stage_parts``: the block's halo from the parts where they lie, item
    by item as the kernel walks them, the addresses from each part's
    strides on its storage.  "direct" copies land in the halo, "f32" ones
    in the part's scratch [pixel][channel], "planes" ones (column pairs
    from an even column, zero past the frame) in its scratch
    [channel][row][column]; "regs" loads 4 floats at a time through
    registers straight into the halo; then zeros past Cin; then, once the copies
    have landed, each scratch is rounded or moved into the halo.  Also
    returns how often each halo position is written."""
    routes = plan[0]
    cin = sum(t.shape[-1] for t in parts)
    P, hr, hc = k // 2, ROWS + k - 1, COLS + k - 1
    pix_n, ps, pairs_n = hr * hc, cp + 8, hc // 2 + 1
    row0, col0 = by * ROWS, bx * COLS
    x0 = (col0 - P) & ~1
    halo = torch.full((pix_n * ps,), -1, dtype=torch.int32)
    writes = torch.zeros(pix_n * ps, dtype=torch.int32)
    scratch = {}

    def put(idx, val):
        halo[idx] = val
        writes[idx] += 1

    off = 0
    for i, t in enumerate(parts):
        (route, vec), ch = routes[i], t.shape[-1]
        sb, sy, sx, sc = _dims(t)
        bits = _bits(t)
        base = t.storage_offset() + b * sb

        def load(addr, ok):
            return torch.where(ok, bits[addr.clamp(0, bits.numel() - 1)], 0)

        if route in ("direct", "f32", "regs"):
            assert ch % vec == 0 and (route != "direct" or off % vec == 0)
            assert route != "regs" or vec == 4
            units = ch // vec
            e = torch.arange(pix_n * units)
            pix, u = e // units, e % units
            y, x = row0 - P + pix // hc, col0 - P + pix % hc
            ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            for j in range(vec):
                v = load(base + y * sy + x * sx + u * vec + j, ok)
                if route == "f32":
                    scratch.setdefault(i, torch.full((pix_n * ch,), -1, dtype=torch.int32))
                    scratch[i][pix * ch + u * vec + j] = v
                else:
                    put(pix * ps + off + u * vec + j, v)
        else:
            assert route == "planes"
            e = torch.arange(ch * hr * pairs_n)
            pr, r, c = e % pairs_n, (e // pairs_n) % hr, e // (pairs_n * hr)
            y, x = row0 - P + r, x0 + 2 * pr
            row_ok = (y >= 0) & (y < H) & (x >= 0)
            plane = scratch.setdefault(i, torch.full((ch * hr * 2 * pairs_n,), -1,
                                                     dtype=torch.int32))
            for j in range(2):  # the copy reads 2 * min(2, W - x) bytes, zero past them
                ok = row_ok & (j < (W - x).clamp(0, 2))
                plane[(c * hr + r) * 2 * pairs_n + 2 * pr + j] = load(base + y * sy + x + j + c * sc, ok)
        off += ch
    nz = cp - cin
    if nz > 0:
        e = torch.arange(pix_n * nz)
        put((e // nz) * ps + cin + e % nz, 0)
    off = 0
    for i, t in enumerate(parts):  # the scratch into the halo, once landed
        route, ch = routes[i][0], t.shape[-1]
        if route in ("f32", "planes"):
            pix, c = torch.arange(pix_n)[:, None], torch.arange(ch)[None, :]
            if route == "f32":
                v = scratch[i][pix * ch + c]
            else:
                col = (col0 - P) - x0 + pix % hc
                v = scratch[i][(c * hr + pix // hc) * 2 * pairs_n + col]
            assert (v != -1).all()  # every value read has landed
            put((pix * ps + off + c).flatten(), v.flatten())
        off += ch
    return halo, writes


def _frames(B, T, C, H, W, seed):
    """A prepared serving chunk (B, T, H, W, C) bf16: the channels-first
    frames through ``_prep_frame``, whose ``movedim`` leaves channel
    stride H*W."""
    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.rollout.autoregressive import _prep_frame

    rng = np.random.default_rng(seed)
    norm = Normalizer(rng.standard_normal(C).astype(np.float32),
                      (1.0 + rng.random(C)).astype(np.float32), 0.5, 2.0)
    raw = torch.tensor(rng.standard_normal((B, T, C, H - 4, W - 6)), dtype=torch.float32)
    return _prep_frame(raw, norm, None, (H, W), torch.bfloat16)


def _part(kind, B, H, W, C, seed):
    """One part of a cell input: "frame" (a serving chunk's step 1, bf16,
    channel stride H*W), "xs" (a training batch's step 1, NHWC bf16),
    "frame32" (the chunk's step in f32, channels-first), "f32" (a carry
    or the previous layer's h', contiguous), "bf16" (a contiguous bf16
    frame), "bf16+2" (one starting 4 bytes past its storage)."""
    if kind == "frame":
        return _frames(B, 3, C, H, W, seed)[:, 1]
    if kind == "frame32":
        return _frames(B, 3, C, H, W, seed).float()[:, 1]
    if kind == "xs":
        return _t(_randn(seed, B, 3, H, W, C)).bfloat16()[:, 1]
    if kind == "f32":
        return _t(_randn(seed, B, H, W, C))
    if kind == "bf16":
        return _t(_randn(seed, B, H, W, C)).bfloat16()
    flat = _t(_randn(seed, B * H * W * C + 2)).bfloat16()
    return flat[2:].view(B, H, W, C)


# (B, H, W, x kind, Cx, h kind, hid, k, the parts' routes[, the shared
# memory the launch may take]): serving layers 1-3 (B 1), training layers
# 1-3 (B 8), config #3's layer 1 (Cin 70), and the other routes (bf16
# parts off their 16-byte alignment, scratch cut by the budget)
PART_CASES = {
    "serve-62+64": (1, 20, 38, "frame", 62, "f32", 64, 5, (("planes", 2), ("f32", 4))),
    "serve-64+32": (1, 20, 38, "f32", 64, "f32", 32, 3, (("f32", 4), ("f32", 4))),
    "serve-32+16": (1, 20, 38, "f32", 32, "f32", 16, 3, (("f32", 4), ("f32", 4))),
    "train-8+64": (8, 12, 20, "xs", 8, "f32", 64, 5, (("direct", 8), ("f32", 4))),
    "train-64+32": (8, 12, 20, "f32", 64, "f32", 32, 3, (("f32", 4), ("f32", 4))),
    "train-32+16": (8, 12, 20, "f32", 32, "f32", 16, 3, (("f32", 4), ("f32", 4))),
    "config3-6+64": (8, 12, 20, "bf16", 6, "f32", 64, 5, (("direct", 2), ("f32", 4))),
    "shifted-12+16": (2, 11, 19, "bf16+2", 12, "bf16", 16, 7, (("direct", 2), ("direct", 4))),
    "budget-32+16": (8, 12, 20, "f32", 32, "f32", 16, 3, (("f32", 4), ("regs", 4)), 115712),
}

# (B, H, W, x kind, Cx, h kind, hid, k[, the shared memory the launch may
# take]): layouts the two-part launch refuses, so the caller concatenates:
# a bf16 part of odd channels, a channels-first frame of odd width (odd
# channel stride), an f32 channels-first frame, a frame's planes past the
# budget, and f32 parts of odd channels past it
REFUSED_CASES = {
    "odd-13+8": (2, 11, 19, "bf16", 13, "f32", 8, 3),
    "odd-width-62+64": (1, 11, 37, "frame", 62, "f32", 64, 7),
    "frame32-62+64": (1, 20, 38, "frame32", 62, "f32", 64, 1),
    "budget-62+64": (1, 20, 38, "frame", 62, "f32", 64, 5, 0),
    "budget-odd-13+10": (2, 11, 19, "f32", 13, "f32", 10, 3, 0),
}


@pytest.mark.parametrize("case", list(PART_CASES))
def test_two_part_stage_equals_the_concatenated_halo(case):
    """Every block at the frame's corners and one inside, of the first and
    the last image: the halo staged from (x, h) where they lie is, byte for
    byte, the halo ``stage_halo`` stages from ``torch.cat([x,
    h.to(torch.bfloat16)], -1)``; no position is written twice and every
    scratch value read has landed; each part takes the route the case
    names, within the card's shared memory."""
    B, H, W, xk, cx, hk, hid, k, routes, *budget = PART_CASES[case]
    x, h = _part(xk, B, H, W, cx, 60), _part(hk, B, H, W, hid, 61)
    if xk.startswith("frame"):
        assert x.stride()[-1] == H * W
    xh = torch.cat([x.to(torch.bfloat16), h.to(torch.bfloat16)], -1)
    cin = cx + hid
    assert cin <= GROUP_CH
    p = _plan(B, H, W, cin, hid, k)
    plan = _parts_plan(x, h, k, p["smem"], *budget)
    assert plan is not None and tuple(plan[0]) == routes and plan[2] <= MAX_SMEM
    gx, gy = p["grid"][0], p["grid"][1]
    blocks = {(by, bx) for by in (0, gy - 1) for bx in (0, gx - 1)} | {(gy // 2, gx // 2)}
    for b in sorted({0, B - 1}):
        for by, bx in sorted(blocks):
            want = _stage_halo(xh, b, by, bx, 0, k, p["vec"], p["cp"])
            got, writes = _stage_parts((x, h), plan, H, W, b, by, bx, k, p["cp"])
            assert torch.equal(got, want), (b, by, bx)
            assert writes.max() == 1 and torch.equal(writes == 1, want != -1)


@pytest.mark.parametrize("case", list(REFUSED_CASES))
def test_two_part_plan_refuses_what_it_cannot_copy(case):
    """A part that no copy or vector load takes, or scratch past the
    budget that no f32 part of 4-float loads can leave, refuses the whole
    launch (the library then launches on the concatenation), where the
    same shapes with a contiguous bf16 x of even channels are taken."""
    B, H, W, xk, cx, hk, hid, k, *budget = REFUSED_CASES[case]
    x, h = _part(xk, B, H, W, cx, 64), _part(hk, B, H, W, hid, 65)
    p = _plan(B, H, W, cx + hid, hid, k)
    assert _parts_plan(x, h, k, p["smem"], *budget) is None
    even = 2 * (cx // 2)
    taken = _parts_plan(_part("bf16", B, H, W, even, 66), _part("f32", B, H, W, hid, 67), k,
                        _plan(B, H, W, even + hid, hid, k)["smem"])
    assert taken is not None and taken[0][0][0] == "direct"


# the two-part plan at the main-path shapes (100 x 154) on an H100 (228 KB
# of shared memory per SM, 1 KB of it reserved per block): (B, x kind, Cx,
# hid, k) -> (the shared memory it may take, routes, shared memory).  The
# hid-64 and hid-32 launches on xh run one block per SM, so the parts may
# take the 227 KB a block may; the hid-16 launch runs two, so the parts
# keep within half an SM: its smaller f32 scratch goes to registers
MAIN_PART_PLANS = {
    (1, "frame", 62, 64, 5): (MAX_SMEM, (("planes", 2), ("f32", 4)), 225120),
    (1, "f32", 64, 32, 3): (MAX_SMEM, (("f32", 4), ("f32", 4)), 172224),
    (1, "f32", 32, 16, 3): (115712, (("f32", 4), ("regs", 4)), 108864),
    (8, "xs", 8, 64, 5): (MAX_SMEM, (("direct", 8), ("f32", 4)), 169344),
    (8, "bf16", 6, 64, 5): (MAX_SMEM, (("direct", 2), ("f32", 4)), 169344),
}


@pytest.mark.parametrize("shape", list(MAIN_PART_PLANS))
def test_two_part_plan_at_the_main_path_shapes(shape):
    """Serving layers 1-3, the remat layer 1 and config #3's: every part on
    a copy or vector-load route, within the shared memory the launch may
    take."""
    B, xk, cx, hid, k = shape
    H, W = 100, 154
    budget, want_routes, want_smem = MAIN_PART_PLANS[shape]
    x, h = _part(xk, B, H, W, cx, 62), _part("f32", B, H, W, hid, 63)
    p = _plan(B, H, W, cx + hid, hid, k)
    routes, _, smem = _parts_plan(x, h, k, p["smem"], budget)  # never None here
    assert (tuple(routes), smem) == (want_routes, want_smem) and smem <= budget


def _pair_cell(B, H, W, cx, hid, k, dtype, seed):
    x = _t(_randn(seed, B, H, W, cx))
    h, c = _t(_randn(seed + 1, B, H, W, hid)), _t(_randn(seed + 2, B, H, W, hid))
    w = _t(_randn(seed + 3, k, k, cx + hid, 4 * hid, scale=(k * k * (cx + hid)) ** -0.5), dtype)
    b = _t(_randn(seed + 4, 4 * hid, scale=0.1))
    return x.to(dtype), h, c, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_cell_forward_takes_the_pair_on_the_cpu(dtype):
    """On the CPU the pair (x, h) is [x; h] in w's dtype: the same h', c'
    bit for bit, for a channels-first frame too and for 100 + 64 channels,
    and the pair's launch counters stay where they were."""
    from nasa_niswan_tpu_torch.ops import convlstm_cell
    from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward

    before = (convlstm_cell.launches, convlstm_cell.parts_launches)
    for cx, hid in ((6, 8), (100, 64)):  # one channel group, and over one
        x, h, c, w, b = _pair_cell(2, 9, 13, cx, hid, 3, dtype, 70)
        for xv in (x, x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
            got = fused_cell_forward((xv, h), c, w, b)
            want = fused_cell_forward(torch.cat([xv.to(dtype), h.to(dtype)], -1), c, w, b)
            assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert (convlstm_cell.launches, convlstm_cell.parts_launches) == before


def test_cells_step_with_the_pair_equals_the_concatenated_input():
    """Three steps of three layers through ``cells_step``: the default cell,
    which takes the pair, bit-equal to the same cell handed the pair
    joined by ``join_xh`` (what a cell that needs one tensor does)."""
    from nasa_niswan_tpu_torch.ops.convlstm_bptt import cells_step
    from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward, join_xh

    B, H, W, C, hids, ks = 2, 9, 13, 5, (8, 4, 4), (5, 3, 3)
    dt = torch.bfloat16
    cells, state, cin = [], [], C
    for i, (hd, k) in enumerate(zip(hids, ks)):
        w = _t(_randn(80 + i, k, k, cin + hd, 4 * hd, scale=(k * k * (cin + hd)) ** -0.5), dt)
        cells.append((w, _t(_randn(90 + i, 4 * hd, scale=0.1))))
        state.append((_t(_randn(100 + i, B, H, W, hd)), _t(_randn(110 + i, B, H, W, hd))))
        cin = hd
    xs = _t(_randn(120, B, 3, H, W, C)).to(dt)
    seen = []

    def concatenated(xh, c, w, b):
        seen.append(isinstance(xh, tuple))
        return fused_cell_forward(join_xh(xh, dt), c, w, b)

    got, want = state, state
    for t in range(3):
        got = cells_step(cells, xs[:, t], got, fused_cell_forward)
        want = cells_step(cells, xs[:, t], want, concatenated)
        for (hg, cg), (hw, cw) in zip(got, want):
            assert torch.equal(hg, hw) and torch.equal(cg, cw)
    assert seen and all(seen)


def test_the_pair_under_grad_gives_the_concatenated_gradients():
    """With grad the pair is concatenated and cast inside
    ``fused_cell_forward`` and takes the per-cell Function: the gradients
    of x, h, c, w and b equal those through the concatenated xh."""
    from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward

    def grads(pair):
        x, h, c, w, b = (t.clone().requires_grad_(True)
                         for t in _pair_cell(2, 9, 13, 6, 8, 3, torch.bfloat16, 130))
        xh = (x, h) if pair else torch.cat([x.to(w.dtype), h.to(w.dtype)], -1)
        h2, c2 = fused_cell_forward(xh, c, w, b)
        (h2.square().sum() + (c2 * 0.5).sum()).backward()
        return [t.grad for t in (x, h, c, w, b)]

    for g, w_ in zip(grads(True), grads(False)):
        assert g is not None and torch.equal(g, w_)
