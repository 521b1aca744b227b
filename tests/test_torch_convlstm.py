"""ConvLSTM modules of the PyTorch port against the JAX package: weight
bridge and checkpoint reader, init, conv, the fused cell (plain version,
which the CPU runs) and ``convlstm_apply``.  Inputs come from numpy and go
to both packages.  The JAX fused kernel runs in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.ops.conv import conv2d as jconv2d  # noqa: E402
from nasa_niswan_tpu.ops.convlstm_pallas2 import (  # noqa: E402
    fused_cell_forward_v2,
    pad_cols,
    padded_cols,
)
from nasa_niswan_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.models import convlstm as tm  # noqa: E402
from nasa_niswan_tpu_torch.ops import _build, convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.ops.conv import conv2d as tconv2d  # noqa: E402

CFG = dict(in_channels=5, hidden_channels=(8, 4), kernel_sizes=(5, 3))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(seed), cfg))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _cell_args(rng, B, H, W, C, hid, k):
    xh = rng.standard_normal((B, H, W, C)).astype(np.float32)
    c = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    w = (rng.standard_normal((k, k, C, 4 * hid)) * 0.1).astype(np.float32)
    b = rng.standard_normal((4 * hid,)).astype(np.float32)
    return xh, c, w, b


# ---- weight bridge, checkpoint, init -------------------------------------


def test_bridge_round_trip_is_bit_exact():
    cfg = jm.ConvLSTMConfig(**CFG)
    tree = _jax_params(cfg)
    back = bridge.params_to_jax(bridge.params_from_jax(tree))
    flat_a, def_a = jax.tree_util.tree_flatten(tree)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_jax_checkpoint(tmp_path):
    """A file written by the JAX package's save_checkpoint (params and an
    optimizer state) loads into the port leaf for leaf."""
    cfg = jm.ConvLSTMConfig(**CFG)
    tree = _jax_params(cfg, seed=3)
    opt = {"mu": jax.tree.map(np.zeros_like, tree), "count": np.int32(7)}
    save_checkpoint(str(tmp_path / "epoch-001"), tree, opt, epoch=1)
    tcfg = tm.ConvLSTMConfig(**CFG)
    for path in (tmp_path / "epoch-001", tmp_path / "epoch-001" / "checkpoint.npz"):
        got = bridge.load_jax_checkpoint(str(path), tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(bridge.params_to_jax(got))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bridge.load_jax_checkpoint(
            str(tmp_path / "epoch-001"),
            tm.ConvLSTMConfig(in_channels=5, hidden_channels=(8,), kernel_sizes=(5,)),
        )
    with pytest.raises(ValueError):
        bridge.load_jax_checkpoint(
            str(tmp_path / "epoch-001"), tm.ConvLSTMConfig(**{**CFG, "in_channels": 6})
        )


@pytest.mark.parametrize("in_channels,count", [(5, 580_305), (62, 945_105)])
def test_param_count_matches_jax(in_channels, count):
    gen = torch.Generator().manual_seed(0)
    params = tm.convlstm_init(gen, tm.ConvLSTMConfig(in_channels=in_channels))
    jparams = jm.convlstm_init(
        jax.random.PRNGKey(0), jm.ConvLSTMConfig(in_channels=in_channels)
    )
    assert tm.convlstm_param_count(params) == count
    assert jm.convlstm_param_count(jparams) == count
    assert jax.tree.map(lambda a: a.shape, jparams) == jax.tree.map(
        lambda t: tuple(t.shape), params
    )


def test_init_distribution_bounds():
    """U(+-1/sqrt(fan_in)) over the combined [x; h] kernel of each cell."""
    cfg = tm.ConvLSTMConfig()
    params = tm.convlstm_init(torch.Generator().manual_seed(1), cfg)
    in_ch = cfg.in_channels
    for cell, hid, k in zip(params["cells"], cfg.hidden_channels, cfg.kernel_sizes):
        bound = 1.0 / np.sqrt((in_ch + hid) * k * k)
        w = torch.cat([cell["w_x"], cell["w_h"]], dim=2)
        for t in (w, cell["b"]):
            assert t.dtype == torch.float32
            assert t.abs().max().item() <= bound
        # uniform: the extremes are reached, and the variance is bound^2 / 3
        assert w.abs().max().item() > 0.99 * bound
        np.testing.assert_allclose(w.var().item(), bound**2 / 3, rtol=0.05)
        in_ch = hid
    head_bound = 1.0 / np.sqrt(cfg.hidden_channels[-1])
    assert params["head"]["w"].abs().max().item() <= head_bound
    # the same seed draws the same weights
    again = tm.convlstm_init(torch.Generator().manual_seed(1), cfg)
    assert torch.equal(again["cells"][0]["w_x"], params["cells"][0]["w_x"])


def test_normalizer_and_zscore_static_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 6, 7)).astype(np.float32)
    mean = rng.standard_normal(5).astype(np.float32)
    std = (1.0 + rng.random(5)).astype(np.float32)
    jn = jdata.Normalizer(mean, std, 0.25, 3.0)
    tn = tdata.Normalizer(mean, std, 0.25, 3.0)
    np.testing.assert_array_equal(
        tn.normalize_x(torch.from_numpy(x)).numpy(), np.asarray(jn.normalize_x(x))
    )
    y = rng.standard_normal((2, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tn.unnormalize_y(torch.from_numpy(y)).numpy(), jn.unnormalize_y(y)
    )
    np.testing.assert_array_equal(
        tn.normalize_y(torch.from_numpy(y)).numpy(), jn.normalize_y(y)
    )
    static = rng.standard_normal((3, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tdata.zscore_static(static), jdata.zscore_static(static)
    )


# ---- conv and the fused cell ----------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_matches_jax_f32(k):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    want = np.asarray(jconv2d(x, w, b, padding=k // 2))
    got = tconv2d(_t(x), _t(w), _t(b), padding=k // 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_head_dtype_rule_matches_jax_bf16():
    """1x1 head: a bf16 product, promoted to f32 by the f32 bias."""
    rng = np.random.default_rng(6)
    h = rng.standard_normal((1, 7, 9, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 16, 1)).astype(np.float32)
    b = rng.standard_normal(1).astype(np.float32)
    want = jconv2d(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), b)
    got = tconv2d(_t(h, torch.bfloat16), _t(w, torch.bfloat16), _t(b))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # both round the product to bf16 once; one bf16 ulp of the product
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2, rtol=8e-3)


def test_gate_update_matches_jax():
    rng = np.random.default_rng(7)
    gates = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    c = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    for want, got in zip(jm.gate_update(gates, c), tm.gate_update(_t(gates), _t(c))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("B,H,W,C,hid,k", [(1, 12, 20, 15, 8, 3), (2, 10, 14, 9, 4, 5)])
def test_plain_cell_f32_matches_jax_xla_cell(B, H, W, C, hid, k):
    """Port cell (CPU: the plain version) vs JAX ``_cell_step_xla``, f32:
    one conv over [x; h] vs two convs summed; atol 1e-5."""
    rng = np.random.default_rng(8)
    cin = C - hid
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    h = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    c = rng.standard_normal((B, H, W, hid)).astype(np.float32)
    cell = {
        "w_x": (rng.standard_normal((k, k, cin, 4 * hid)) * 0.1).astype(np.float32),
        "w_h": (rng.standard_normal((k, k, hid, 4 * hid)) * 0.1).astype(np.float32),
        "b": rng.standard_normal(4 * hid).astype(np.float32),
    }
    jh, jc = jm._cell_step_xla(cell, x, h, c, k, jnp.float32)
    xh = torch.cat([_t(x), _t(h)], dim=-1)
    w = torch.cat([_t(cell["w_x"]), _t(cell["w_h"])], dim=2)
    th, tc = convlstm_cell.fused_cell_forward(xh, _t(c), w, _t(cell["b"]))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def _pallas2_valid(xh, c, w, b, k, dtype):
    """JAX fused kernel (interpret mode) in its margin layout, cropped back
    to the valid columns."""
    W = xh.shape[2]
    o = max(k // 2, 1)
    wp = padded_cols(W, o)
    h1, c1 = fused_cell_forward_v2(
        pad_cols(jnp.asarray(xh, dtype), o, wp), pad_cols(jnp.asarray(c), o, wp),
        jnp.asarray(w, dtype), jnp.asarray(b), k, o, W, interpret=True,
    )
    return np.asarray(h1)[:, :, o : o + W], np.asarray(c1)[:, :, o : o + W]


@pytest.mark.parametrize(
    "B,H,W,C,hid,k",
    [(1, 16, 24, 9, 8, 3), (2, 20, 28, 13, 16, 5), (1, 10, 12, 5, 4, 1)],
)
def test_cell_f32_matches_jax_kernel(B, H, W, C, hid, k):
    """Port cell vs the JAX fused kernel ``_cell_kernel_v2`` (interpret
    mode), f32, valid columns; atol 1e-5."""
    xh, c, w, b = _cell_args(np.random.default_rng(9), B, H, W, C, hid, k)
    jh, jc = _pallas2_valid(xh, c, w, b, k, jnp.float32)
    th, tc = convlstm_cell.fused_cell_forward(_t(xh), _t(c), _t(w), _t(b))
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)


@pytest.mark.parametrize("B,H,W,C,hid,k", [(1, 16, 24, 9, 8, 3), (2, 20, 28, 13, 16, 5)])
def test_cell_bf16_matches_jax_kernel(B, H, W, C, hid, k):
    """bf16 operands, f32 sums in both: the JAX fused kernel and the port
    read the same bf16 values, so only the order of the f32 sums and the
    transcendental implementations differ.  atol 2e-3 leaves room for the
    bf16 operands' larger products; measured differences are ~1e-6."""
    xh, c, w, b = _cell_args(np.random.default_rng(10), B, H, W, C, hid, k)
    jh, jc = _pallas2_valid(xh, c, w, b, k, jnp.bfloat16)
    th, tc = convlstm_cell.fused_cell_forward(
        _t(xh, torch.bfloat16), _t(c), _t(w, torch.bfloat16), _t(b)
    )
    np.testing.assert_allclose(th.numpy(), jh, atol=2e-3)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-3)


def test_cell_wrapper_checks_and_cpu_dispatch():
    xh, c, w, b = (_t(a) for a in _cell_args(np.random.default_rng(11), 1, 6, 7, 5, 4, 3))
    before = convlstm_cell.launches
    h1, c1 = convlstm_cell.fused_cell_forward(xh, c, w, b)
    h2, c2 = convlstm_cell.fused_cell_forward_plain(xh, c, w, b)
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    assert convlstm_cell.launches == before  # CPU tensors never launch
    bad = [
        ((xh[..., :4], c, w, b), ValueError),  # Cin mismatch
        ((xh, c[..., :3], w, b), ValueError),  # hidden mismatch
        ((xh, c, w[:2, :2], b), ValueError),  # even kernel
        ((xh.transpose(1, 2), c.transpose(1, 2), w, b), ValueError),  # strided
        ((xh.half(), c, w.half(), b), TypeError),
        ((xh.bfloat16(), c, w, b), TypeError),  # mixed operand dtypes
        ((xh, c.bfloat16(), w, b), TypeError),
        ((xh[0], c, w, b), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            convlstm_cell.fused_cell_forward(*args)


def test_custom_op_fake_impl_gives_shapes():
    """The op's fake (meta) implementation: shapes without a launch."""
    dev = torch.device("meta")
    xh = torch.empty((2, 9, 11, 7), device=dev, dtype=torch.bfloat16)
    c = torch.empty((2, 9, 11, 4), device=dev)
    w = torch.empty((3, 3, 7, 16), device=dev, dtype=torch.bfloat16)
    b = torch.empty((16,), device=dev)
    before = convlstm_cell.launches
    h_new, c_new = convlstm_cell.fused_cell_forward(xh, c, w, b)
    assert h_new.shape == c_new.shape == c.shape
    assert h_new.dtype == c_new.dtype == torch.float32
    assert convlstm_cell.launches == before


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """The kernel modules import without nvcc; building then raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()
    assert _build.library_path().name.startswith("libniswan_kernels_")


# ---- convlstm_apply --------------------------------------------------------


def _apply_inputs(seed=12, B=2, T=4, H=10, W=14, C=5, hid=(8, 4)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    init = [
        (rng.standard_normal((B, H, W, h)).astype(np.float32) * 0.5,
         rng.standard_normal((B, H, W, h)).astype(np.float32) * 0.5)
        for h in hid
    ]
    return x, init


def test_convlstm_apply_f32_matches_jax():
    """Per-step taps, initial_state and return_state against JAX at f32."""
    jcfg = jm.ConvLSTMConfig(**CFG)
    tcfg = tm.ConvLSTMConfig(**CFG)
    tree = _jax_params(jcfg)
    params = bridge.params_from_jax(tree)
    x, init = _apply_inputs()
    want_pred, want_taps, want_state = jm.convlstm_apply(
        tree, x, jcfg, return_per_step=True, initial_state=init, return_state=True
    )
    got_pred, got_taps, got_state = tm.convlstm_apply(
        params, torch.from_numpy(x), tcfg, return_per_step=True,
        initial_state=[(_t(h), _t(c)) for h, c in init], return_state=True,
    )
    assert got_taps.shape == want_taps.shape == (2, 4, 10, 14, 1)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), atol=1e-5)
    np.testing.assert_allclose(got_taps.numpy(), np.asarray(want_taps), atol=1e-5)
    for (jh, jc), (th, tc) in zip(want_state, got_state):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)

    # zero initial state, custom tap, prediction only
    tap = lambda h: h.sum(-1)  # noqa: E731
    want_pred, want_taps = jm.convlstm_apply(
        tree, x, jcfg, return_per_step=True, tap_fn=lambda h: jnp.sum(h, -1)
    )
    got_pred, got_taps = tm.convlstm_apply(
        params, torch.from_numpy(x), tcfg, return_per_step=True, tap_fn=tap
    )
    np.testing.assert_allclose(got_taps.numpy(), np.asarray(want_taps), atol=1e-5)
    got_only = tm.convlstm_apply(params, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(got_only.numpy(), got_pred.numpy())
    np.testing.assert_allclose(got_only.numpy(), np.asarray(want_pred), atol=1e-5)


def test_convlstm_apply_bf16_matches_jax_pallas2():
    """bf16 against the JAX fused kernel in interpret mode (f32 sums in
    both); atol 2e-3 for bf16 re-rounding of h between steps."""
    jcfg = jm.ConvLSTMConfig(**CFG, compute_dtype="bfloat16", cell_impl="pallas2")
    tcfg = tm.ConvLSTMConfig(**CFG, compute_dtype="bfloat16")
    tree = _jax_params(jcfg)
    x, init = _apply_inputs(T=3)
    want_pred, want_state = jm.convlstm_apply(
        tree, x, jcfg, initial_state=init, return_state=True
    )
    got_pred, got_state = tm.convlstm_apply(
        bridge.params_from_jax(tree), torch.from_numpy(x), tcfg,
        initial_state=init, return_state=True,
    )
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), atol=2e-3)
    for (jh, jc), (th, tc) in zip(want_state, got_state):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-3)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)


def test_convlstm_module_matches_functional():
    tcfg = tm.ConvLSTMConfig(**CFG)
    params = tm.convlstm_init(torch.Generator().manual_seed(2), tcfg)
    model = tm.ConvLSTM(tcfg, params)
    names = dict(model.named_parameters())
    assert set(names) == {
        "cells.0.w_x", "cells.0.w_h", "cells.0.b",
        "cells.1.w_x", "cells.1.w_h", "cells.1.b", "head.w", "head.b",
    }
    assert sum(p.numel() for p in model.parameters()) == tm.convlstm_param_count(params)
    x, _ = _apply_inputs(T=2)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), return_state=True)
    want = tm.convlstm_apply(params, torch.from_numpy(x), tcfg, return_state=True)
    assert torch.equal(got[0], want[0])
    # a seeded module without explicit params is reproducible
    a = tm.ConvLSTM(tcfg, generator=torch.Generator().manual_seed(5))
    b = tm.ConvLSTM(tcfg, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
