"""The fused cell's emit_gates and xg modes, the per-cell training route and
the v1 cell (B4) of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them, on
margin-layout inputs cropped to the valid columns.  Inputs are seeded numpy,
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.ops import convlstm_pallas as jv1  # noqa: E402
from nasa_niswan_tpu.ops import convlstm_pallas2 as jv2  # noqa: E402
from nasa_niswan_tpu_torch.ops import convgrad, convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.ops.convlstm_cell import (  # noqa: E402
    FusedCell,
    FusedCellXg,
    fused_cell_forward,
    fused_cell_forward_plain,
    fused_cell_gates,
)

# (B, H, W, Cin, hid, k); H = 16 gives the Pallas kernel 8-row tiles > k // 2
SHAPES = [(1, 16, 24, 9, 8, 3), (2, 16, 20, 13, 4, 5), (1, 16, 12, 5, 4, 1)]
BF16_STEP = 2.0**-7  # one bf16 step, relative


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _inputs(seed, B, H, W, C, hid, k):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "xh": f(B, H, W, C), "c": f(B, H, W, hid), "w": f(k, k, C, 4 * hid) * 0.2,
        "b": f(4 * hid) * 0.1, "xg": f(B, H, W, 4 * hid),
        "dh": f(B, H, W, hid), "dc": f(B, H, W, hid),
    }


def _geom(W, k):
    o = max(k // 2, 1)
    return o, jv2.padded_cols(W, o)


def _m(a, o, wp, dtype=jnp.float32):
    return jv2.pad_cols(jnp.asarray(a, dtype), o, wp)


def _crop(a, o, W):
    return np.asarray(jnp.asarray(a, jnp.float32))[:, :, o : o + W]


# ---- the two modes against fused_cell_forward_v2 (interpret mode) ----------


@pytest.mark.parametrize("with_xg", [False, True])
@pytest.mark.parametrize("B,H,W,C,hid,k", SHAPES)
def test_modes_f32_match_jax_kernel(B, H, W, C, hid, k, with_xg):
    """emit_gates, with and without xg, f32: h', c' and the gates within
    1e-5 (f32 sums in another order)."""
    a = _inputs(0, B, H, W, C, hid, k)
    o, wp = _geom(W, k)
    want = jv2.fused_cell_forward_v2(
        _m(a["xh"], o, wp), _m(a["c"], o, wp), jnp.asarray(a["w"]),
        jnp.asarray(a["b"]), k, o, W, _m(a["xg"], o, wp) if with_xg else None,
        interpret=True, emit_gates=True,
    )
    got = fused_cell_gates(_t(a["xh"]), _t(a["c"]), _t(a["w"]), _t(a["b"]),
                           _t(a["xg"]) if with_xg else None)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _crop(w_, o, W), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_xg", [False, True])
def test_modes_bf16_match_jax_kernel(with_xg):
    """bf16 operands and hoisted gates: the gates are f32 sums rounded to
    bf16 in both, so they agree within one bf16 step plus 1e-5; h' and c'
    come from the unrounded gates, 1e-5."""
    B, H, W, C, hid, k = 2, 16, 20, 13, 8, 5
    a = _inputs(1, B, H, W, C, hid, k)
    o, wp = _geom(W, k)
    bf = jnp.bfloat16
    want = jv2.fused_cell_forward_v2(
        _m(a["xh"], o, wp, bf), _m(a["c"], o, wp), jnp.asarray(a["w"], bf),
        jnp.asarray(a["b"]), k, o, W, _m(a["xg"], o, wp, bf) if with_xg else None,
        interpret=True, emit_gates=True,
    )
    bt = torch.bfloat16
    got = fused_cell_gates(_t(a["xh"], bt), _t(a["c"]), _t(a["w"], bt), _t(a["b"]),
                           _t(a["xg"], bt) if with_xg else None)
    assert got[2].dtype == bt
    np.testing.assert_allclose(got[0].numpy(), _crop(want[0], o, W), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), _crop(want[1], o, W), atol=1e-5)
    np.testing.assert_allclose(got[2].float().numpy(), _crop(want[2], o, W),
                               rtol=BF16_STEP, atol=1e-5)


def test_xg_serving_mode_matches_jax_kernel():
    """The xg launch without gates (hoisted serving) returns (h', c') only,
    equal to the emit_gates mode's."""
    B, H, W, C, hid, k = 1, 16, 24, 8, 8, 3
    a = _inputs(2, B, H, W, C, hid, k)
    o, wp = _geom(W, k)
    want = jv2.fused_cell_forward_v2(
        _m(a["xh"], o, wp), _m(a["c"], o, wp), jnp.asarray(a["w"]),
        jnp.asarray(a["b"]), k, o, W, _m(a["xg"], o, wp), interpret=True,
    )
    with torch.no_grad():
        got = fused_cell_forward(_t(a["xh"]), _t(a["c"]), _t(a["w"]), _t(a["b"]),
                                 _t(a["xg"]))
    assert len(got) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _crop(w_, o, W), atol=1e-5)


# ---- the per-cell Functions against jax.vjp of the custom VJPs -------------


def _port_vjp(fn, ins, dh, dc):
    ins = [t.clone().requires_grad_(True) for t in ins]
    out = fn(*ins)
    return torch.autograd.grad(out, ins, (dh, dc))


@pytest.mark.parametrize("B,H,W,C,hid,k", SHAPES)
def test_fused_cell_grads_match_jax_vjp(B, H, W, C, hid, k):
    """``FusedCell`` (through ``fused_cell_forward`` under grad) vs
    ``jax.vjp`` of ``_fused_cell_v2``, f32, on the valid columns: dxh and
    dc_prev 2e-5, dw and db 2e-4 (the JAX package's own tolerances)."""
    a = _inputs(3, B, H, W, C, hid, k)
    o, wp = _geom(W, k)
    _, vjp = jax.vjp(
        lambda xh, c, w, b: jv2._fused_cell_v2(xh, c, w, b, k, o, W),
        _m(a["xh"], o, wp), _m(a["c"], o, wp), jnp.asarray(a["w"]), jnp.asarray(a["b"]),
    )
    want = vjp((_m(a["dh"], o, wp), _m(a["dc"], o, wp)))
    got = _port_vjp(fused_cell_forward, [_t(a[n]) for n in ("xh", "c", "w", "b")],
                    _t(a["dh"]), _t(a["dc"]))
    np.testing.assert_allclose(got[0].numpy(), _crop(want[0], o, W), atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), _crop(want[1], o, W), atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cell_xg_grads_match_jax_vjp(dtype):
    """``FusedCellXg`` vs ``jax.vjp`` of ``_fused_cell_v2_xg``: (dxg, dh,
    dc_prev, dw_h, db).  f32: 2e-5 / 2e-4 as above; bf16: dxg and dh are
    bf16 in both (dgates and the conv gradient rounded at the same place),
    held to 2e-2 of each gradient's largest entry."""
    B, H, W, hid, k = 2, 16, 20, 8, 5
    a = _inputs(4, B, H, W, hid, hid, k)
    o, wp = _geom(W, k)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    _, vjp = jax.vjp(
        lambda xg, h, c, w, b: jv2._fused_cell_v2_xg(xg, h, c, w, b, k, o, W),
        _m(a["xg"], o, wp, jd), _m(a["xh"], o, wp, jd), _m(a["c"], o, wp),
        jnp.asarray(a["w"], jd), jnp.asarray(a["b"]),
    )
    want = vjp((_m(a["dh"], o, wp), _m(a["dc"], o, wp)))
    ins = [_t(a["xg"], td), _t(a["xh"], td), _t(a["c"]), _t(a["w"], td), _t(a["b"])]
    got = _port_vjp(lambda xg, h, c, w, b: fused_cell_forward(h, c, w, b, xg), ins,
                    _t(a["dh"]), _t(a["dc"]))
    assert [g.dtype for g in got] == [td, td, torch.float32, td, torch.float32]
    wants = [_crop(want[0], o, W), _crop(want[1], o, W), _crop(want[2], o, W),
             np.asarray(want[3], np.float32), np.asarray(want[4])]
    for i, (g, w_) in enumerate(zip(got, wants)):
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w_, atol=2e-5 if i in (0, 1, 2) else 2e-4)
        else:
            assert np.abs(g - w_).max() <= 2e-2 * np.abs(w_).max()


def test_fused_cell_bf16_grads_match_jax_vjp():
    """``FusedCell`` in bf16 vs ``jax.vjp`` of ``_fused_cell_v2``: both keep
    bf16 gates and round dgates and dxh to bf16; each gradient within 2e-2
    of its largest entry."""
    B, H, W, C, hid, k = 2, 16, 20, 13, 8, 5
    a = _inputs(5, B, H, W, C, hid, k)
    o, wp = _geom(W, k)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(
        lambda xh, c, w, b: jv2._fused_cell_v2(xh, c, w, b, k, o, W),
        _m(a["xh"], o, wp, bf), _m(a["c"], o, wp), jnp.asarray(a["w"], bf),
        jnp.asarray(a["b"]),
    )
    want = vjp((_m(a["dh"], o, wp), _m(a["dc"], o, wp)))
    bt = torch.bfloat16
    got = _port_vjp(fused_cell_forward, [_t(a["xh"], bt), _t(a["c"]), _t(a["w"], bt),
                                         _t(a["b"])], _t(a["dh"]), _t(a["dc"]))
    wants = [_crop(want[0], o, W), _crop(want[1], o, W), np.asarray(want[2], np.float32),
             np.asarray(want[3])]
    for g, w_ in zip(got, wants):
        assert np.abs(g.float().numpy() - w_).max() <= 2e-2 * np.abs(w_).max()


@pytest.mark.parametrize("with_xg", [False, True])
def test_per_cell_functions_equal_eager_autograd(with_xg):
    """The Functions' backward is the vector-Jacobian product of the plain
    cell: f32, 1e-5."""
    a = _inputs(6, 2, 7, 9, 6, 4, 3)
    ins = [_t(a[n]) for n in ("xh", "c", "w", "b")]
    if with_xg:
        a = _inputs(6, 2, 7, 9, 4, 4, 3)
        ins = [_t(a[n]) for n in ("xh", "c", "w", "b")] + [_t(a["xg"])]
    got = _port_vjp(fused_cell_forward, ins, _t(a["dh"]), _t(a["dc"]))
    want = _port_vjp(fused_cell_forward_plain, ins, _t(a["dh"]), _t(a["dc"]))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=1e-5, rtol=1e-5)


def test_per_cell_route_only_under_grad():
    """Under grad with an input requiring it the step is the Function; else
    the plain version, with no autograd state, equal values."""
    a = _inputs(7, 1, 6, 7, 5, 4, 3)
    xh, c, w, b = (_t(a[n]) for n in ("xh", "c", "w", "b"))
    with torch.no_grad():
        want = fused_cell_forward(xh, c, w, b)
    assert want[0].grad_fn is None
    got = fused_cell_forward(xh, c, w.requires_grad_(True), b)
    assert type(got[0].grad_fn).__name__ == FusedCell.__name__ + "Backward"
    torch.testing.assert_close(got[0].detach(), want[0], atol=0, rtol=0)
    xg = _t(_inputs(7, 1, 6, 7, 4, 4, 3)["xg"]).requires_grad_(True)
    got = fused_cell_forward(_t(a["c"]), c, _t(a["w"][:, :, :4]), b, xg)
    assert type(got[0].grad_fn).__name__ == FusedCellXg.__name__ + "Backward"


def test_mode_wrappers_check_args_and_never_launch_on_cpu():
    a = _inputs(8, 1, 6, 7, 5, 4, 3)
    xh, c, w, b, xg = (_t(a[n]) for n in ("xh", "c", "w", "b", "xg"))
    before = (convlstm_cell.launches, convlstm_cell.gates_launches,
              convlstm_cell.xg_launches, convgrad.dw_launches)
    fused_cell_gates(xh, c, w, b)
    _port_vjp(fused_cell_forward, [xh, c, w, b], _t(a["dh"]), _t(a["dc"]))
    assert (convlstm_cell.launches, convlstm_cell.gates_launches,
            convlstm_cell.xg_launches, convgrad.dw_launches) == before
    for bad, err in ((xg[..., :8], ValueError), (xg.bfloat16(), ValueError),
                     (xg.transpose(1, 2), ValueError)):
        with pytest.raises(err):
            fused_cell_gates(xh, c, w, b, bad)
    for args, err in (((xh, xg[..., :8], 3), ValueError), ((xh, xg, 4), ValueError),
                      ((xh, xg.bfloat16(), 3), TypeError)):
        with pytest.raises(err):
            convgrad.conv_dw(*args)


def test_mode_custom_op_fake_impls_give_shapes():
    """The new ops' fake (meta) implementations: shapes and dtypes."""
    dev = torch.device("meta")
    xh = torch.empty((2, 9, 11, 7), device=dev, dtype=torch.bfloat16)
    c = torch.empty((2, 9, 11, 4), device=dev)
    w = torch.empty((3, 3, 7, 16), device=dev, dtype=torch.bfloat16)
    b = torch.empty((16,), device=dev)
    xg = torch.empty((2, 9, 11, 16), device=dev, dtype=torch.bfloat16)
    h, c2, g = fused_cell_gates(xh, c, w, b, xg)
    assert h.shape == c2.shape == c.shape and g.shape == xg.shape and g.dtype == xh.dtype
    with torch.no_grad():
        h, c2 = fused_cell_forward(xh, c, w, b, xg)
    assert h.shape == c.shape and h.dtype == torch.float32
    dw = convgrad.conv_dw(xh, xg, 3)
    assert dw.shape == (3, 3, 7, 16) and dw.dtype == torch.float32


@pytest.mark.parametrize("B,H,W,C,n,k", [(2, 9, 11, 7, 16, 3), (1, 8, 6, 5, 12, 5)])
def test_conv_dw_plain_is_the_weight_gradient(B, H, W, C, n, k):
    """``conv_dw``'s plain version is the weight gradient of the SAME conv
    (autograd of ``F.conv2d``), f32, 1e-4."""
    rng = np.random.default_rng(9)
    x, g = _t(rng.standard_normal((B, H, W, C))), _t(rng.standard_normal((B, H, W, n)))
    w = torch.zeros((k, k, C, n), requires_grad=True)
    out = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                     padding=k // 2).permute(0, 2, 3, 1)
    (want,) = torch.autograd.grad(out, w, g)
    torch.testing.assert_close(convgrad.conv_dw(x, g, k), want, atol=1e-4, rtol=1e-4)


# ---- B4: the v1 cell and its VJP -------------------------------------------


@pytest.mark.parametrize("B,H,W,C,hid,k", SHAPES[:2])
def test_v1_cell_matches_jax_pallas(B, H, W, C, hid, k):
    """B4 (``convlstm_pallas.fused_cell_forward``, interpret mode) computes
    B1's plain mode in the standard layout: the port's cell equals it, f32,
    1e-5."""
    a = _inputs(10, B, H, W, C, hid, k)
    want = jv1.fused_cell_forward(
        jnp.asarray(a["xh"]), jnp.asarray(a["c"]), jnp.asarray(a["w"]),
        jnp.asarray(a["b"]), k, interpret=True,
    )
    with torch.no_grad():
        got = fused_cell_forward(*(_t(a[n]) for n in ("xh", "c", "w", "b")))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5)


@pytest.mark.parametrize("B,H,W,C,hid,k", SHAPES[:2])
def test_v1_cell_vjp_matches_cell_grads(B, H, W, C, hid, k):
    """B4's VJP ``_fused_bwd`` recomputes the gates, as the port's
    ``cell_grads`` (B2 then B3) does: (dxh, dc_prev, dw, db) vs ``jax.vjp``
    of ``_fused_cell``, f32, 2e-5 / 2e-4."""
    a = _inputs(11, B, H, W, C, hid, k)
    _, vjp = jax.vjp(lambda xh, c, w, b: jv1._fused_cell(xh, c, w, b, k),
                     *(jnp.asarray(a[n]) for n in ("xh", "c", "w", "b")))
    want = vjp((jnp.asarray(a["dh"]), jnp.asarray(a["dc"])))
    got = convgrad.cell_grads(*(_t(a[n]) for n in ("xh", "c", "dh", "dc", "w", "b")))
    for i, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5 if i < 2 else 2e-4)
