"""The port's data-parallel training of the stateful single-step families
(``ModelBundle.apply``'s ``mesh``, ``ops/conv.batch_norm``'s ``group``,
``ops/conv.dropout2d``'s ``shard``) on two gloo ranks: the UNet's dp = 2
step, whose BatchNorms take the global batch's statistics, against the
port's single-device step on the global batch and the JAX package's GSPMD
``make_dp_train_step`` on a (2,) mesh of its CPU devices; the pix2pix
generator's dp = 2 step with dropout on, every rank drawing the global
batch's masks, against the port's single-device step with the same
generator; the GAN step's refusal on the ranks; and ``--dp-devices 2`` of
the training CLI on a UNet, whose snapshot loads in the JAX package.

One world of two ranks is spawned once (tests/torch_train_ranks.py).
Shapes: UNet features (4, 8, 16, 32) on a 16 x 24 grid padded to 32 x 32,
pix2pix features 4 on an 88 x 88 grid padded to 256 x 256, global batch 4,
one Adam step (lr 1e-3, betas (0.5, 0.999)).

Tolerances: parameters after the step and the new running statistics atol
1e-5.  A conv bias ahead of a training-mode BatchNorm (every UNet block's
``conv1/b`` and ``conv2/b``) has a zero gradient in exact arithmetic: its
gradient is rounding noise, which Adam turns into a step of about lr of
either sign, so those leaves are held through their gradients instead,
below 1e-6 of the largest gradient in both runs (as tests/test_torch_unet.py
holds them).  The losses rel 1e-5 (against JAX 1e-4: XLA's convs).
Gradients per leaf, relative to the leaf's largest: f32 within 1e-4
(GRAD_TOL; measured up to 7.4e-6), the UNet in f64 within 1e-10
(GRAD_TOL_F64; measured 1.5e-14), where a wrong scale of any leaf (a
BatchNorm cotangent all-reduced twice, a wrong dp divisor) is off by O(1).
The UNet is held against JAX in f64 only: in f32 JAX's own gradient is up
to 3.7e-2 of a leaf's largest from its f64 value (the port's 1e-6)."""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import Normalizer as JNormalizer  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu.parallel.dp import make_dp_train_step  # noqa: E402
from nasa_niswan_tpu.train import checkpoint as jckpt  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer, SingleStepDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.train import __main__ as train_cli  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.config import parse_args  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402

LR, BETAS = 1e-3, (0.5, 0.999)
BS = 4
FEATS = (4, 8, 16, 32)
CASES = {
    "unet": dict(model="UNet-dp", kw=dict(in_channels=5, unet_features=FEATS),
                 geo=dict(padded_shape=(32, 32), grid_shape=(16, 24)),
                 data=dict(T=60, H=16, W=24, seed=7), seed=0),
    "pix2pix": dict(model="PIX2PIX-dp", kw=dict(in_channels=5, pix2pix_features=4),
                    geo=dict(padded_shape=(256, 256), grid_shape=(88, 88)),
                    data=dict(T=40, H=88, W=88, seed=8), seed=11),
}
# leaves whose gradient is zero in exact arithmetic: conv biases ahead of BatchNorm
NOISE = ("conv1/b", "conv2/b")
GRAD_TOL, GRAD_TOL_F64 = 1e-4, 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    out = {"opt": (LR, BETAS)}
    for name, c in CASES.items():
        ds = SingleStepDataset(synthetic_e33oma_90d(**c["data"]), period="train")
        xs, ys = zip(*(ds[i] for i in range(BS)))
        bundle = build_model(c["model"], **c["kw"])
        params, state = bundle.init(torch.Generator().manual_seed(3), "cpu")
        n = ds.normalizer
        out[name] = dict(model=c["model"], kw=c["kw"], geo=c["geo"], seed=c["seed"],
                         params=bridge.params_to_jax(params),
                         state=None if state is None else bridge.params_to_jax(state),
                         norm=(np.asarray(n.x_mean), np.asarray(n.x_std), float(n.y_mean),
                               float(n.y_std)),
                         batch=(np.stack(xs), np.stack(ys)),
                         paths=bridge.tree_paths(params))
    return out


@pytest.fixture(scope="module")
def world(case):
    return launch.spawn(ranks.stateful_dp_world, 2, "cpu", case, timeout=300)


def _single_device(c, dropout=True, dtype=np.float32):
    """The port's step on the global batch, the weights, state and batch in
    ``dtype``: (loss, params, grads, state)."""
    bundle = build_model(c["model"], **c["kw"])
    params = bridge.params_from_jax(_cast(c["params"], dtype))
    for t in param_leaves(params):
        t.requires_grad_(True)
    state = None if c["state"] is None else bridge.params_from_jax(_cast(c["state"], dtype))
    opt = make_optimizer(params, LR, BETAS)
    step = make_train_step(bundle, Normalizer(*c["norm"]), opt, **c["geo"])
    rng = torch.Generator().manual_seed(c["seed"]) if dropout else None
    new_state, m = step(params, state, *_cast(c["batch"], dtype), rng)
    return (m["loss"].item(), [t.detach().numpy() for t in param_leaves(params)],
            [t.grad.numpy() for t in param_leaves(params)],
            [t.numpy() for t in bridge.tree_leaves(new_state)])


def _hold(paths, got, want, got_grads, want_grads):
    """Parameters atol 1e-5, the exact-zero-gradient leaves through their
    gradients (module docstring)."""
    scale = max(np.max(np.abs(g)) for g in want_grads)
    for path, a, b, ga, gb in zip(paths, got, want, got_grads, want_grads):
        if path.endswith(NOISE):
            assert np.max(np.abs(ga)) <= 1e-6 * scale and np.max(np.abs(gb)) <= 1e-6 * scale
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_single_device_on_the_global_batch(case, world, name):
    """dp = 2 (global BatchNorm statistics, global dropout masks) against
    one device on the global batch: parameters, running statistics and the
    loss; both ranks end equal."""
    got = world[0][name]
    loss, params, grads, state = _single_device(case[name])
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _hold(case[name]["paths"], got["params"], params, got["grads"], grads)
    assert len(got["state"]) == len(state) == (36 if name == "unet" else 0)
    for a, b in zip(got["state"], state):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for key in ("params", "state"):
        for a, b in zip(world[1][name][key], got[key]):
            np.testing.assert_array_equal(a, b)


def test_unet_dp_step_matches_jax_dp_step(case, world):
    """The UNet's dp = 2 step against JAX's GSPMD ``make_dp_train_step`` on
    a (2,) mesh of its CPU devices, from the same weights and batch."""
    c = case["unet"]
    bundle = j_build_model(c["model"], **c["kw"])
    opt = jloop.make_optimizer(LR, BETAS)
    step = make_dp_train_step(bundle, JNormalizer(*c["norm"]), opt,
                              jmesh.make_mesh(dp=2, devices=jax.devices()[:2]), **c["geo"])
    p, s, _, m = step(c["params"], c["state"], opt.init(c["params"]), *c["batch"],
                      jax.random.PRNGKey(0))
    got = world[0]["unet"]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    want = [np.asarray(a) for a in jax.tree.leaves(p)]
    for path, a, b, g in zip(c["paths"], got["params"], want, got["grads"]):
        if not path.endswith(NOISE):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)
    for a, b in zip(got["state"], jax.tree.leaves(s)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _jax_grads(c, dtype=np.float32):
    """JAX's gradient of the training loss (``make_loss_fn``) at the shared
    weights on the global batch, dropout off, in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        bundle = j_build_model(c["model"], **c["kw"])
        x, y = jloop._device_preprocess(*_cast(c["batch"], dtype), JNormalizer(*c["norm"]),
                                        c["geo"]["padded_shape"], None)
        loss_fn = jloop.make_loss_fn(bundle, c["geo"]["grid_shape"])
        grads = jax.jit(jax.grad(lambda p, s: loss_fn(p, s, x, y, None)[0]))(
            _cast(c["params"], dtype), _cast(c["state"], dtype))
        return [np.asarray(g) for g in jax.tree.leaves(grads)]


def _hold_grads(paths, got, want, tol):
    """Per leaf max |got - want| within ``tol`` of the leaf's largest
    |want|; the exact-zero-gradient leaves are held by ``_hold``."""
    for path, a, b in zip(paths, got, want):
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        if not path.endswith(NOISE):
            err = np.max(np.abs(a - b)) / np.max(np.abs(b))
            assert err <= tol, (path, err)


@pytest.mark.parametrize("name", ["unet", "unet-f64", "pix2pix", "pix2pix-nodrop"])
def test_dp_gradients_match_per_leaf(case, world, name):
    """The dp = 2 step's all-reduced gradients, leaf by leaf (relative to
    the leaf's largest), against the port's single-device step on the
    global batch (GRAD_TOL) and, with dropout off, against JAX's gradient
    of the same loss: the pix2pix generator's in f32 (GRAD_TOL), the
    UNet's in f64 (GRAD_TOL_F64; module docstring);
    the parameter checks of
    ``test_dp_step_matches_single_device_on_the_global_batch`` next to
    them."""
    c = case[name.split("-")[0]]
    got = world[0][name]
    dtype = np.float64 if name.endswith("f64") else np.float32
    loss, params, grads, _ = _single_device(c, dropout=not name.endswith("nodrop"),
                                            dtype=dtype)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    tol = GRAD_TOL_F64 if dtype == np.float64 else GRAD_TOL
    _hold_grads(c["paths"], got["grads"], grads, tol)
    _hold(c["paths"], got["params"], params, got["grads"], grads)
    if name in ("unet-f64", "pix2pix-nodrop"):
        _hold_grads(c["paths"], got["grads"], _jax_grads(c, dtype), tol)


def test_gan_step_refuses_data_parallel_ranks(world):
    assert "no data-parallel form" in world[0]["gan_refused"]


def test_train_cli_dp_devices_trains_a_unet(tmp_path):
    """``--dp-devices 2`` on a UNet (two CPU ranks) trains, and its epoch
    checkpoint, BatchNorm state included, loads in the JAX package."""
    snap = str(tmp_path / "u")
    cfg = parse_args(["--device", "cpu", "--model", "UNet-dpcli", "--in-channels", "5",
                      "--unet-features", *map(str, FEATS), "--input-size", "32", "32",
                      "--batch-size", "4", "--synthetic-steps", "60", "--synthetic-grid",
                      "16", "24", "--num-epochs", "1", "--checkpoint-every", "1",
                      "--dp-devices", "2", "--snapshot-dir", snap])
    cfg.dump()
    out = train_cli.main(cfg)
    assert np.isfinite(out["logger"]["MSELoss"]).all()
    jbundle = j_build_model("UNet-dpcli", in_channels=5, unet_features=FEATS)
    tmpl_p, tmpl_s = jbundle.init(jax.random.PRNGKey(0))
    lp, lo, ls, meta = jckpt.load_checkpoint(
        os.path.join(snap, "epoch-001"), tmpl_p, jloop.make_optimizer(LR, BETAS).init(tmpl_p),
        state_template=tmpl_s)
    assert meta["epoch"] == 1 and meta["n_state"] == 36
    for a, b in zip(jax.tree.leaves(lp), param_leaves(out["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(ls), bridge.tree_leaves(out["state"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
