"""The port's conv primitives, UNet, weight bridge and checkpoints against the
JAX package: every new primitive of ``ops/conv.py`` (reflect padding at
every map size, 1x1 included), the UNet in eval and train mode (output, new
running statistics, gradients of the MSE + L1 loss per leaf), UNet
checkpoints read and written by either package, the unchanged ConvLSTM
checkpoint layout, and ``fit`` on a UNet against JAX's first epoch.

Weights are drawn by the port's init and cross the bridge, so both
packages compute with the same numbers.  Tolerances: a primitive within
1e-5 of its output's largest magnitude (f32); a whole model's output, new
statistics and per-leaf gradients within 1e-4 of their largest magnitude
(f32 sums in other orders through ~20 layers).  A conv bias ahead of a
training-mode BatchNorm, which removes the mean, has a zero gradient in
exact arithmetic: both packages' are rounding noise, held below 1e-6 of the
largest gradient.  Adam turns that noise into steps of up to ~lr of either
sign, which a BatchNorm's running mean carries; so after an epoch of
``fit`` (10 steps, lr 1e-3) the running means are held within 2e-3, the
running variances within 1e-4 relative, the epoch's loss rtol 1e-4 and its
validation R^2 (1 minus a ratio of O(1) sums) atol 1e-4."""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import SingleStepDataset as JSingleStep  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as j_synthetic  # noqa: E402
from nasa_niswan_tpu.models import unet as jm  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.ops import conv as jconv  # noqa: E402
from nasa_niswan_tpu.train import checkpoint as jckpt  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import SingleStepDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models import unet as tm  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.ops import conv as tconv  # noqa: E402
from nasa_niswan_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402

FEATS = (4, 8, 16, 32)
TOL_OP, TOL_MODEL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size:
        err = np.max(np.abs(got - want))
        assert err <= rel * max(np.max(np.abs(want)), 1e-30), (err, np.max(np.abs(want)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- primitives ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_reflect_pad_equals_jnp_pad_at_every_size(n, p):
    x = _randn(np.random.default_rng(n * 10 + p), 2, n, n + 1, 3)
    want = jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(tconv.reflect_pad(_t(x), p, p).numpy(), want)


@pytest.mark.parametrize("hw,k,stride,pad,mode", [
    ((9, 11), 3, 1, 1, "zeros"),
    ((9, 11), 3, 2, 0, "zeros"),
    ((8, 8), 4, 2, 1, "reflect"),
    ((7, 9), 4, 2, 1, "reflect"),
    ((2, 2), 4, 2, 1, "reflect"),
    ((1, 1), 4, 2, 1, "reflect"),  # the generator's bottleneck at 128x128: empty
    ((1, 1), 4, 1, 1, "reflect"),
    ((6, 5), 1, 1, 0, "zeros"),
])
def test_conv2d_matches_jax(hw, k, stride, pad, mode):
    rng = np.random.default_rng(sum(hw) + k)
    x, w, b = _randn(rng, 2, *hw, 3), _randn(rng, k, k, 3, 5), _randn(rng, 5)
    want = jconv.conv2d(x, w, b, stride=stride, padding=pad, pad_mode=mode)
    got = tconv.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=pad, pad_mode=mode)
    _close(got, want, TOL_OP)


def test_empty_conv_still_gives_zero_gradients():
    w = torch.ones(4, 4, 3, 2, requires_grad=True)
    x = torch.ones(2, 1, 1, 3, requires_grad=True)
    out = tconv.conv2d(x, w, stride=2, padding=1, pad_mode="reflect")
    assert out.shape == (2, 0, 0, 2)
    up = tconv.conv2d_transpose(out, torch.ones(4, 4, 2, 2, requires_grad=True),
                                stride=2, padding=1)
    assert up.shape == (2, 1, 1, 2)
    up.sum().backward()
    assert torch.equal(w.grad, torch.zeros_like(w)) and torch.equal(x.grad, torch.zeros_like(x))


@pytest.mark.parametrize("hw,k,stride,pad", [
    ((4, 5), 2, 2, 0), ((3, 3), 4, 2, 1), ((1, 1), 4, 2, 1), ((0, 0), 4, 2, 1),
])
def test_conv2d_transpose_matches_jax(hw, k, stride, pad):
    rng = np.random.default_rng(k + pad + sum(hw))
    x, w, b = _randn(rng, 2, *hw, 3), _randn(rng, k, k, 5, 3), _randn(rng, 5)
    want = jconv.conv2d_transpose(x, w, b, stride=stride, padding=pad)
    got = tconv.conv2d_transpose(_t(x), _t(w), _t(b), stride=stride, padding=pad)
    _close(got, want, TOL_OP)


def test_pool_norms_and_leaky_relu_match_jax():
    rng = np.random.default_rng(3)
    x = _randn(rng, 3, 7, 9, 4)
    scale, bias = _randn(rng, 4), _randn(rng, 4)
    _close(tconv.max_pool2d(_t(x)), jconv.max_pool2d(x), TOL_OP)
    _close(tconv.instance_norm(_t(x), _t(scale), _t(bias)),
           jconv.instance_norm(x, scale, bias), TOL_OP)
    _close(tconv.instance_norm(_t(x)), jconv.instance_norm(x), TOL_OP)
    _close(tconv.leaky_relu(_t(x)), jconv.leaky_relu(x), TOL_OP)
    # the JAX form's slope at 0 is 1
    z = torch.zeros(3, requires_grad=True)
    tconv.leaky_relu(z).sum().backward()
    assert torch.equal(z.grad, torch.ones(3))


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(training):
    rng = np.random.default_rng(4)
    x = _randn(rng, 3, 5, 6, 4)
    scale, bias, mean = _randn(rng, 4), _randn(rng, 4), _randn(rng, 4)
    var = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    want, (wm, wv) = jconv.batch_norm(x, scale, bias, mean, var, training=training)
    tx = _t(x).requires_grad_(True)
    rm, rv = _t(mean), _t(var)
    got, (gm, gv) = tconv.batch_norm(tx, _t(scale), _t(bias), rm, rv, training=training)
    _close(got.detach(), want, TOL_OP)
    _close(gm, wm, TOL_OP)
    _close(gv, wv, TOL_OP)
    # the caller's statistics are left alone, and the new ones hold no graph
    assert np.array_equal(rm.numpy(), mean) and np.array_equal(rv.numpy(), var)
    assert not gm.requires_grad and not gv.requires_grad


def test_dropout2d_drops_whole_channels():
    x = torch.ones(64, 3, 5, 32)
    gen = torch.Generator().manual_seed(0)
    y = tconv.dropout2d(x, 0.5, gen, training=True)
    per_channel = y[:, :1, :1, :]
    assert torch.equal(y, per_channel.expand_as(y))  # one draw per (sample, channel)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert 0.4 < (per_channel == 0).float().mean().item() < 0.6
    assert tconv.dropout2d(x, 0.5, gen, training=False) is x
    assert tconv.dropout2d(x, 0.5, None, training=True) is x


def test_init_shapes_and_tree_match_jax():
    """The port's init builds the JAX package's trees (names, flatten order,
    shapes) at full width: about 31.0 M parameters at in_channels 5."""
    jp, js = jax.eval_shape(partial(jm.unet_init, config=jm.UNetConfig()),
                            jax.random.PRNGKey(0))
    bundle = build_model("UNet-x", in_channels=5)
    tp, ts = bundle.init(torch.Generator().manual_seed(0), "cpu")
    for j, t in ((jp, tp), (js, ts)):
        assert jax.tree.structure(j) == jax.tree.structure(bridge.params_to_jax(t))
        assert [a.shape for a in jax.tree.leaves(j)] == [
            tuple(b.shape) for b in bridge.tree_leaves(t)]
    assert sum(t.numel() for t in bridge.tree_leaves(tp)) == 31_044_673
    assert all(t.requires_grad for t in bridge.tree_leaves(tp))
    assert not bundle.is_sequence


def test_initializers_follow_torch_defaults():
    from nasa_niswan_tpu_torch.models.init import normal_002_init, torch_conv_transpose_init

    gen = torch.Generator().manual_seed(1)
    w, b = torch_conv_transpose_init(gen, 2, 2, 64, 32)
    bound = 1.0 / np.sqrt(32 * 2 * 2)  # fan_in = out_ch * kh * kw
    assert w.shape == (2, 2, 32, 64) and b.shape == (32,)
    assert w.abs().max() <= bound and b.abs().max() <= bound
    assert w.abs().max() > 0.9 * bound
    n = normal_002_init(gen, 3, 3, 64, 64)
    assert n.shape == (3, 3, 64, 64) and abs(n.std().item() - 0.02) < 1e-3


# --- the UNet -------------------------------------------------------------

def _x(seed=6, B=2):
    return _randn(np.random.default_rng(seed), B, 32, 32, 5)


def batch_statistics(apply, params, state, x):
    """``state`` with its running statistics set to the batch statistics of
    ``x`` (one training-mode forward: new = 0.9 old + 0.1 batch).  With the
    fresh (0, 1) statistics, or any not matched to the activations, the
    N(0, 0.02) weights shrink every eval-mode activation towards zero and
    the output to the head's bias; matched, eval normalizes as training
    does."""
    with torch.no_grad():
        _, new = apply(params, state, x, training=True)
    return bridge.tree_unflatten(state, [
        (n - 0.9 * o) / 0.1 for n, o in zip(bridge.tree_leaves(new), bridge.tree_leaves(state))])


@pytest.fixture(scope="module")
def unet():
    """Port-drawn weights and running statistics matched to a batch, with
    their JAX trees."""
    cfg = tm.UNetConfig(in_channels=5, features=FEATS)
    params, state = tm.unet_init(torch.Generator().manual_seed(0), cfg)
    state = batch_statistics(
        lambda p, s, x, training: tm.unet_apply(p, s, x, training=training), params, state,
        torch.from_numpy(_x(5)))
    for t in bridge.tree_leaves(params):
        t.requires_grad_(True)
    jcfg = jm.UNetConfig(in_channels=5, features=FEATS)
    return (cfg, params, state, jcfg, bridge.params_to_jax(params),
            bridge.params_to_jax(state))


@pytest.mark.parametrize("training", [False, True])
def test_unet_matches_jax(unet, training):
    _, params, state, jcfg, jp, js = unet
    x = _x()
    want, want_state = jax.jit(jm.unet_apply, static_argnames="training")(
        jp, js, x, training=training)
    before = [t.clone() for t in bridge.tree_leaves(state)]
    got, new_state = tm.unet_apply(params, state, _t(x), training=training)
    _close(got.detach(), want, TOL_MODEL)
    for g, w in zip(bridge.tree_leaves(new_state), jax.tree.leaves(want_state)):
        _close(g, w, TOL_MODEL)
    # the input state is left unchanged
    assert all(torch.equal(a, b) for a, b in zip(before, bridge.tree_leaves(state)))
    if not training:
        assert all(a is b for a, b in zip(bridge.tree_leaves(new_state),
                                          bridge.tree_leaves(state)))


def test_unet_gradients_match_jax(unet):
    """Gradients of the training loss (MSE + L1, train mode) per leaf."""
    _, params, state, _, jp, js = unet
    x = _x(7)
    y = _randn(np.random.default_rng(8), 2, 32, 32)

    def j_loss(p):
        out, _ = jm.unet_apply(p, js, x, training=True)
        d = y - out[..., 0]
        return jnp.mean(d ** 2) + jnp.mean(jnp.abs(d))

    want = jax.jit(jax.grad(j_loss))(jp)
    out, _ = tm.unet_apply(params, state, _t(x), training=True)
    d = _t(y) - out[..., 0]
    loss = torch.mean(d ** 2) + torch.mean(torch.abs(d))
    grads = torch.autograd.grad(loss, bridge.tree_leaves(params))
    largest = max(float(np.max(np.abs(w))) for w in jax.tree.leaves(want))
    paths, _ = jax.tree_util.tree_flatten_with_path(want)
    for g, (path, w) in zip(grads, paths):
        if _ahead_of_batch_norm(path):
            assert max(g.abs().max().item(), np.max(np.abs(w))) <= 1e-6 * largest
        else:
            _close(g, w, TOL_MODEL)


def _ahead_of_batch_norm(path) -> bool:
    keys = [k.key for k in path]
    return keys[-1] == "b" and keys[-2] in ("conv1", "conv2")


def test_unet_tree_round_trips_the_bridge(unet):
    _, params, state, _, jp, js = unet
    for tree, port in ((jp, params), (js, state)):
        back = bridge.params_to_jax(bridge.params_from_jax(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_jax_unet_checkpoint_loads_in_the_port(unet, tmp_path):
    """JAX's save_checkpoint (params, Adam state, BatchNorm state) -> the
    port's load_checkpoint and bridge.load_jax_checkpoint: the same leaves,
    and the same eval predictions as JAX's."""
    cfg, params, state, jcfg, jp, js = unet
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3, b1=0.5, b2=0.999)
    path = str(tmp_path / "epoch-003")
    jckpt.save_checkpoint(path, jp, opt.init(jp), learning_rate=1e-3, epoch=3,
                          model_state=js)
    tmpl, tmpl_state = tm.unet_init(torch.Generator().manual_seed(9), cfg)
    got_p, opt_state, got_s, meta = tckpt.load_checkpoint(path, tmpl,
                                                          state_template=tmpl_state)
    assert meta["epoch"] == 3 and meta["n_state"] == 36 and opt_state["step"] == 0
    for a, b in ((got_p, jp), (got_s, js)):
        for t, w in zip(bridge.tree_leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(t.detach().numpy(), w)
    bp, bs = bridge.load_jax_checkpoint(path, tmpl, state_template=tmpl_state)
    assert all(torch.equal(a.detach(), b) for a, b in zip(
        bridge.tree_leaves((got_p, got_s)), bridge.tree_leaves((bp, bs))))
    x = _x(10)
    want, _ = jax.jit(jm.unet_apply, static_argnames="training")(jp, js, x)
    got, _ = tm.unet_apply(got_p, got_s, _t(x))
    _close(got.detach(), want, TOL_MODEL)


def test_port_unet_checkpoint_loads_in_jax(unet, tmp_path):
    """The port's save_checkpoint (params, Adam after a step, BatchNorm
    state) -> JAX's load_checkpoint with its templates: the same leaves, the
    same Adam moments, and the same eval predictions."""
    cfg, params, state, jcfg, jp, js = unet
    p = bridge.params_from_jax(jp)
    for t in bridge.tree_leaves(p):
        t.requires_grad_(True)
    opt = tloop.make_optimizer(p, 1e-3, (0.5, 0.999))
    out, _ = tm.unet_apply(p, state, _t(_x(11)), training=True)
    out.square().mean().backward()
    opt.step()
    path = str(tmp_path / "epoch-001")
    tckpt.save_checkpoint(path, p, opt, learning_rate=1e-3, epoch=1, model_state=state)
    jopt = jloop.make_optimizer(1e-3, (0.5, 0.999))
    tmpl_p, tmpl_s = jax.eval_shape(partial(jm.unet_init, config=jcfg), jax.random.PRNGKey(0))
    tmpl_p, tmpl_s = (jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), t)
                      for t in (tmpl_p, tmpl_s))
    lp, lo, ls, meta = jckpt.load_checkpoint(path, tmpl_p, jopt.init(tmpl_p),
                                             state_template=tmpl_s)
    assert meta["n_state"] == 36 and int(lo.inner_state[0].count) == 1
    for a, b in zip(jax.tree.leaves((lp, ls)), bridge.tree_leaves((p, state))):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    for a, t in zip(jax.tree.leaves(lo.inner_state[0].mu), bridge.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), opt.state[t]["exp_avg"].numpy())
    x = _x(12)
    want, _ = jax.jit(jm.unet_apply, static_argnames="training")(lp, ls, x)
    got, _ = tm.unet_apply(p, state, _t(x))
    _close(got.detach(), want, TOL_MODEL)


def test_convlstm_checkpoint_layout_is_unchanged(tmp_path):
    """A ConvLSTM checkpoint keeps its keys, leaf order and meta: p<i> in
    flatten order, o<i> for Adam, no state leaves."""
    cfg = ConvLSTMConfig(in_channels=5, hidden_channels=(4, 3), kernel_sizes=(3, 3))
    bundle = build_model("LSTM-x", in_channels=5, hidden_channels=(4, 3), kernel_sizes=(3, 3))
    params, state = bundle.init(torch.Generator().manual_seed(0), "cpu")
    assert state is None
    opt = tloop.make_optimizer(params, 1e-3, (0.5, 0.999))
    path = str(tmp_path / "epoch-002")
    tckpt.save_checkpoint(path, params, opt, learning_rate=1e-3, epoch=2)
    order = [c[k] for c in params["cells"] for k in ("b", "w_h", "w_x")] + [
        params["head"][k] for k in ("b", "w")]
    with np.load(f"{path}/checkpoint.npz") as data:
        assert sorted(data.files) == sorted([f"p{i}" for i in range(8)]
                                            + [f"o{i}" for i in range(6 + 1 + 16)])
        for i, t in enumerate(order):
            np.testing.assert_array_equal(data[f"p{i}"], t.detach().numpy())
    with open(f"{path}/checkpoint_meta.json") as f:
        meta = json.load(f)
    assert meta == {
        "n_params": 8, "n_opt": 23, "n_state": 0, "learning_rate": 1e-3, "epoch": 2,
        "params_treedef": "ConvLSTM {cells: [{b, w_h, w_x}], head: {b, w}}",
        "opt_treedef": "inject_hyperparams(adam) (count, hyperparams, (adam count, mu, nu))",
        "state_treedef": "",
    }
    loaded = bridge.load_jax_checkpoint(path, cfg)
    assert all(torch.equal(a, b.detach()) for a, b in zip(
        bridge.tree_leaves(loaded), bridge.tree_leaves(params)))


# --- fit --------------------------------------------------------------------

def test_fit_unet_matches_jax_first_epoch(tmp_path):
    """One epoch of ``fit`` on a UNet from the same weights (10 steps of
    bs 4, the BatchNorm state threaded, validation on it) against JAX's:
    the epoch's loss, its validation R^2 and the final state."""
    data = synthetic_e33oma_90d(T=60, H=16, W=24, seed=7)
    kw = dict(model="UNet-f", in_channels=5, unet_features=FEATS, input_size=(32, 32),
              batch_size=4, num_epochs=1, checkpoint_every=0)
    tds = [SingleStepDataset(data, period=p) for p in ("train", "val")]
    jds = [JSingleStep(j_synthetic(T=60, H=16, W=24, seed=7), period=p)
           for p in ("train", "val")]
    bundle = build_model("UNet-f", in_channels=5, unet_features=FEATS)
    params, state = bundle.init(torch.Generator().manual_seed(3), "cpu")
    jbundle = j_build_model("UNet-f", in_channels=5, unet_features=FEATS)
    jout = jloop.fit(jbundle, *jds, JTrainConfig(snapshot_dir=str(tmp_path / "j"), **kw),
                     init_params=bridge.params_to_jax(params),
                     init_state=bridge.params_to_jax(state), verbose=False)
    tout = tloop.fit(bundle, *tds, TrainConfig(snapshot_dir=str(tmp_path / "t"),
                                               device="cpu", **kw),
                     device="cpu", init_params=params, init_state=state, verbose=False)
    np.testing.assert_allclose(tout["logger"]["MSELoss"], jout["logger"]["MSELoss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tout["logger"]["r2_score_val"],
                               jout["logger"]["r2_score_val"], rtol=0, atol=1e-4)
    paths, _ = jax.tree_util.tree_flatten_with_path(jout["state"])
    for a, (path, b) in zip(bridge.tree_leaves(tout["state"]), paths):
        if path[-1].key == "mean":
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-3)
        else:
            _close(a, b, TOL_MODEL)
