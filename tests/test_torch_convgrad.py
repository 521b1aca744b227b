"""The training backward of the PyTorch port against the JAX package: the
fused cell backward (B2), the SAME data-gradient conv (B3) and the per-cell
``cell_grads`` (the CPU runs their plain versions), their plain building
blocks, and the whole-scan BPTT autograd Function against
``jax.value_and_grad`` through ``cell_impl="pallas2", remat=True``.  The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.  Inputs are seeded numpy, handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.ops import convgrad_pallas as jcg  # noqa: E402
from nasa_niswan_tpu.ops.convlstm_pallas2 import (  # noqa: E402
    _conv_grads,
    _elementwise_bwd,
    pad_cols,
    padded_cols,
)
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.models import convlstm as tm  # noqa: E402
from nasa_niswan_tpu_torch.ops import convgrad  # noqa: E402
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    dw_per_tap,
    elementwise_bwd,
    fused_cell_forward_plain,
)

SHAPES = [(1, 16, 24, 9, 8, 3), (2, 20, 28, 13, 16, 5), (1, 10, 12, 5, 4, 1)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _bwd_args(seed, B, H, W, C, hid, k):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, H, W, C)).astype(np.float32)
    c = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    dh = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    dc = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    w = (rng.standard_normal((k, k, C, 4 * hid)) * 0.1).astype(np.float32)
    b = rng.standard_normal((4 * hid,)).astype(np.float32)
    return xh, c, dh, dc, w, b


def _margin(a, o, wp):
    return pad_cols(jnp.asarray(a), o, wp)


# ---- the per-cell backward against the JAX Pallas kernels ------------------


@pytest.mark.parametrize("B,H,W,C,hid,k", SHAPES)
def test_cell_grads_matches_jax_pallas(B, H, W, C, hid, k):
    """Port ``cell_grads`` (CPU: plain) vs ``cell_grads_pallas`` in
    interpret mode on the valid columns, f32, with the JAX package's own
    tolerances for its kernels: dxh and dc_prev 2e-5, dw and db 2e-4."""
    xh, c, dh, dc, w, b = _bwd_args(1, B, H, W, C, hid, k)
    o = max(k // 2, 1)
    wp = padded_cols(W, o)
    want = jcg.cell_grads_pallas(
        _margin(xh, o, wp), _margin(c, o, wp), _margin(dh, o, wp),
        _margin(dc, o, wp), jnp.asarray(w), jnp.asarray(b), k, o, W,
        interpret=True,
    )
    got = convgrad.cell_grads(*(_t(a) for a in (xh, c, dh, dc, w, b)))
    sl = np.s_[:, :, o : o + W]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[sl], atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[sl], atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-4)


def test_fused_cell_bwd_bf16_matches_jax_pallas():
    """bf16 operands: dgates rounded to bf16 in both, so they agree to one
    bf16 step (2**-7 relative) plus 1e-6; dw sums bf16 products in f32 in
    both, atol 2e-3 for a sum of ~2,000 products of O(1)."""
    B, H, W, C, hid, k = 2, 20, 28, 13, 16, 5
    xh, c, dh, dc, w, b = _bwd_args(2, B, H, W, C, hid, k)
    o = k // 2
    wp = padded_cols(W, o)
    want = jcg.fused_cell_bwd_v2(
        _margin(xh, o, wp).astype(jnp.bfloat16), _margin(c, o, wp),
        _margin(dh, o, wp), _margin(dc, o, wp), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), k, o, W, interpret=True,
    )
    got = convgrad.fused_cell_bwd(
        _t(xh, torch.bfloat16), _t(c), _t(dh), _t(dc), _t(w, torch.bfloat16), _t(b)
    )
    sl = np.s_[:, :, o : o + W]
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(
        got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))[sl],
        rtol=2.0**-7, atol=1e-6,
    )
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[sl], atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-3)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-4)


@pytest.mark.parametrize("B,H,W,cin,cout,k", [(1, 15, 24, 32, 9, 3), (2, 20, 28, 16, 13, 5)])
def test_conv_same_matches_jax_pallas(B, H, W, cin, cout, k):
    """B3's plain version vs ``conv_same_v2`` (interpret mode) on the valid
    columns, f32, atol 1e-5; ragged output channels."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    o = k // 2
    wp = padded_cols(W, o)
    want = jcg.conv_same_v2(_margin(x, o, wp), jnp.asarray(w), k, o, W, interpret=True)
    got = convgrad.conv_same(_t(x), _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want)[:, :, o : o + W], atol=1e-5
    )


def test_elementwise_bwd_and_conv_grads_match_jax():
    """The plain building blocks vs ``_elementwise_bwd`` (margin 0, so its
    mask keeps every column) and ``_conv_grads`` (dx: B3 on the flipped
    kernel; dw: ``dw_per_tap``), f32."""
    rng = np.random.default_rng(4)
    gates = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    c, dh, dc = (rng.standard_normal((2, 6, 9, 4)).astype(np.float32) for _ in range(3))
    want = _elementwise_bwd(gates, c, dh, dc, 0, 9)
    got = elementwise_bwd(_t(gates), _t(c), _t(dh), _t(dc))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6)
    x = rng.standard_normal((2, 6, 9, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 16)).astype(np.float32)
    want_dx, want_dw = _conv_grads(x, w, gates, 3)
    got_dx = convgrad.conv_same(_t(gates), convgrad.flip_kernel(_t(w)))
    got_dw = dw_per_tap(_t(x), _t(gates), 3)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-4)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), atol=1e-4)


def test_cell_grads_equal_autograd_of_plain_cell():
    """``cell_grads`` is the vector-Jacobian product of the plain cell."""
    xh, c, dh, dc, w, b = (_t(a) for a in _bwd_args(5, 2, 7, 9, 6, 4, 3))
    args = [t.clone().requires_grad_(True) for t in (xh, c, w, b)]
    h_new, c_new = fused_cell_forward_plain(*args)
    want = torch.autograd.grad((h_new, c_new), args, (dh, dc))
    got = convgrad.cell_grads(xh, c, dh, dc, w, b)
    for g, w_ in zip(got, (want[0], want[1], want[2], want[3])):
        torch.testing.assert_close(g, w_, atol=1e-5, rtol=1e-5)


def test_wrappers_check_args_and_never_launch_on_cpu():
    xh, c, dh, dc, w, b = (_t(a) for a in _bwd_args(6, 1, 6, 7, 5, 4, 3))
    before = (convgrad.cell_bwd_launches, convgrad.conv_same_launches)
    convgrad.cell_grads(xh, c, dh, dc, w, b)
    assert (convgrad.cell_bwd_launches, convgrad.conv_same_launches) == before
    bad_bwd = [
        ((xh, c, dh[..., :3], dc, w, b), ValueError),
        ((xh, c, dh, dc.transpose(1, 2), w, b), ValueError),
        ((xh, c, dh.double(), dc, w, b), ValueError),
        ((xh.bfloat16(), c, dh, dc, w, b), TypeError),
    ]
    for args, err in bad_bwd:
        with pytest.raises(err):
            convgrad.fused_cell_bwd(*args)
    for args, err in (((xh, w[:2, :2]), ValueError), ((xh, w[:, :, :4]), ValueError),
                      ((xh.half(), w.half()), TypeError)):
        with pytest.raises(err):
            convgrad.conv_same(*args)


def test_custom_op_fake_impls_give_shapes():
    """The ops' fake (meta) implementations: shapes and dtypes, no launch."""
    dev = torch.device("meta")
    xh = torch.empty((2, 9, 11, 7), device=dev, dtype=torch.bfloat16)
    c = torch.empty((2, 9, 11, 4), device=dev)
    w = torch.empty((3, 3, 7, 16), device=dev, dtype=torch.bfloat16)
    b = torch.empty((16,), device=dev)
    dg, dcp, dw, db = convgrad.fused_cell_bwd(xh, c, c, c, w, b)
    assert dg.shape == (2, 9, 11, 16) and dg.dtype == torch.bfloat16
    assert dcp.shape == c.shape and dw.shape == w.shape and db.shape == (16,)
    assert dw.dtype == db.dtype == torch.float32
    out = convgrad.conv_same(dg, convgrad.flip_kernel(w))
    assert out.shape == (2, 9, 11, 7) and out.dtype == torch.float32


# ---- the whole-scan BPTT against jax.value_and_grad ------------------------

LAYERS = dict(hidden_channels=(4, 4), kernel_sizes=(5, 3))


def _bptt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 16, 24, 5)).astype(np.float32)
    state0 = [
        tuple(rng.standard_normal((2, 16, 24, 4)).astype(np.float32) for _ in range(2))
        for _ in range(2)
    ]
    return x, state0


def _jax_value_and_grad(tree, x, state0, dtype):
    """The JAX whole-scan BPTT (pallas2 + remat, fused Pallas backward in
    interpret mode); the loss taps the prediction and the returned carry."""
    cfg = jm.ConvLSTMConfig(5, compute_dtype=dtype, cell_impl="pallas2",
                            remat=True, **LAYERS)

    def f(params, x, st):
        pred, fs = jm.convlstm_apply(params, x, cfg, initial_state=st, return_state=True)
        return jnp.sum(pred**2) + sum(jnp.sum(h) + jnp.sum(c * c) for h, c in fs)

    st = [tuple(map(jnp.asarray, s)) for s in state0]
    return jax.value_and_grad(f, argnums=(0, 1, 2))(tree, jnp.asarray(x), st)


def _port_value_and_grad(params, x, state0, dtype, **kw):
    cfg = tm.ConvLSTMConfig(5, compute_dtype=dtype, remat=True, **LAYERS)
    leaves = [t.requires_grad_(True) for cell in params["cells"] for t in cell.values()]
    xt = _t(x).requires_grad_(True)
    st = [tuple(_t(a).requires_grad_(True) for a in s) for s in state0]
    pred, fs = tm.convlstm_apply(params, xt, cfg, initial_state=st, return_state=True, **kw)
    loss = (pred**2).sum() + sum(h.sum() + (c * c).sum() for h, c in fs)
    g = torch.autograd.grad(loss, leaves + [xt] + [t for s in st for t in s])
    n = len(leaves)
    return loss, g[:n], g[n], g[n + 1 :]


def _jax_leaves(grads):
    """(cell grads in the port's w_x, w_h, b order, dx, state0 grads)."""
    gp, gx, gs = grads
    cells = [t for cell in gp["cells"] for t in (cell["w_x"], cell["w_h"], cell["b"])]
    return cells, gx, [t for s in gs for t in s]


def test_bptt_f32_matches_jax_value_and_grad():
    """Loss and gradients w.r.t. params, input and initial state, f32, at
    the JAX package's own BPTT tolerances (atol 2e-4, rtol 1e-4)."""
    x, state0 = _bptt_inputs()
    tree = jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(0), jm.ConvLSTMConfig(5, **LAYERS)))
    want_v, want_g = _jax_value_and_grad(tree, x, state0, "float32")
    loss, gp, gx, gs = _port_value_and_grad(bridge.params_from_jax(tree), x, state0, "float32")
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    wp, wx, ws = _jax_leaves(want_g)
    for got, want in zip(list(gp) + [gx] + list(gs), wp + [wx] + ws):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)


def test_bptt_bf16_matches_jax_value_and_grad():
    """bf16 compute dtype: both round xh, w and dgates to bf16 but in
    different summation orders, so a gate cotangent may land one bf16 step
    apart; the gradients are held to 2e-2 of each leaf's largest entry."""
    x, state0 = _bptt_inputs(1)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(
        jax.random.PRNGKey(1), jm.ConvLSTMConfig(5, **LAYERS)))
    want_v, want_g = _jax_value_and_grad(tree, x, state0, "bfloat16")
    loss, gp, gx, gs = _port_value_and_grad(bridge.params_from_jax(tree), x, state0, "bfloat16")
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=2e-3)
    wp, wx, ws = _jax_leaves(want_g)
    for got, want in zip(list(gp) + [gx] + list(gs), wp + [wx] + ws):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_bptt_matches_eager_autograd_oracle(dtype, tol):
    """The autograd Function against eager autograd through the plain cell
    (``grads_fn=None``), relative to each gradient's largest entry: f32 sums
    in other orders; bf16 rounds dgates, dw and dxh at other places."""
    x, state0 = _bptt_inputs(2)
    params = tm.convlstm_init(torch.Generator().manual_seed(3), tm.ConvLSTMConfig(5, **LAYERS))
    loss, *got = _port_value_and_grad(params, x, state0, dtype)
    loss_o, *want = _port_value_and_grad(
        params, x, state0, dtype, cell_fn=fused_cell_forward_plain, grads_fn=None
    )
    np.testing.assert_allclose(loss.item(), loss_o.item(), rtol=1e-6)
    flat = lambda g: list(g[0]) + [g[1]] + list(g[2])  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()


def test_bptt_route_only_when_differentiating():
    """No grad, or per-step taps: the plain time loop (nothing saved);
    with grad and ``remat`` the Function, whose result equals the loop's."""
    x, _ = _bptt_inputs(3)
    cfg = tm.ConvLSTMConfig(5, remat=True, **LAYERS)
    params = tm.convlstm_init(torch.Generator().manual_seed(4), cfg)
    with torch.no_grad():
        want = tm.convlstm_apply(params, _t(x), cfg)
    for t in (t for cell in params["cells"] for t in cell.values()):
        t.requires_grad_(True)
    got = tm.convlstm_apply(params, _t(x), cfg)
    assert got.grad_fn is not None
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)
    pred, taps = tm.convlstm_apply(params, _t(x), cfg, return_per_step=True)
    torch.testing.assert_close(pred.detach(), want, atol=0, rtol=0)
    assert taps.shape == (2, 4, 16, 24, 1)


def test_convlstm_module_is_trainable():
    """The nn.Module's parameters require grad; serving under inference
    mode still runs without autograd state."""
    cfg = tm.ConvLSTMConfig(5, **LAYERS)
    model = tm.ConvLSTM(cfg, generator=torch.Generator().manual_seed(5))
    assert all(p.requires_grad for p in model.parameters())
    x, _ = _bptt_inputs(4)
    (model(_t(x)) ** 2).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    with torch.inference_mode():
        out = model(_t(x))
    assert out.grad_fn is None
