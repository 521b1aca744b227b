"""The port's spatially sharded training and evaluation of every family
(nasa_niswan_tpu_torch/parallel/spatial.py's steps, the UNet and the
pix2pix generator on tiles with the gather rule, parallel/halo.py's
reflect halo, gather and cut) on gloo ranks, against the port's
single-device steps and the JAX package's GSPMD ``make_spatial_train_step``
on a mesh of the same shape (the 8 CPU devices of tests/conftest.py).

One world of four ranks is spawned once (tests/torch_train_ranks.py) and
lays out the meshes (1, 2, 2), (2, 1, 2) and (1, 1, 4).  Models:

* the ConvLSTM with the hoisted input conv (``precompute_input_conv``) on
  ``tiny_setup``'s 16 x 24 grid padded to 20 x 28 (C 5, hidden (4, 4), k
  (5, 3), T 3, batch 8), in f32 and in bf16;
* a UNet with features 4/8/16/32 on a 24 x 40 grid padded to 32 x 64
  (batch 4), in f32 and f64: every mesh but (2, 1, 2) gathers before the
  fourth pool; and on 32 x 48 over (1, 1, 4), whose 12-pixel-wide tiles
  gather before the third pool;
* a pix2pix generator with features 4 on a 200 x 240 grid padded to 256 x
  256 (batch 4), in f32 with dropout on (the masks drawn from one
  generator seed) and in f64 with it off: its innermost levels run whole.

Tolerances: per leaf, relative to the leaf's largest gradient, f32 within
1e-4 (GRAD_TOL), f64 within 1e-10 (GRAD_TOL_F64), bf16 within 5e-2
(``chip_smoke.TOL_GRAD``; the sharded hoist keeps its weight gradient in
f32 where the single-device step rounds it to bf16); a leaf counted
lat x lon times, or a norm's sums taken twice, is off by O(1).  The f32
UNet's leaves deep in the net are sums that cancel: in f32 the tiles' order
of summation moves them by up to 2.4e-3 of their own largest (their
largest is 1e-6 to 1e-4 of the model's; in f64 the same leaves agree to
1e-10), so in f32 they are held within 1e-4 of the model's largest
gradient and per leaf in f64.  The loss rel 1e-5 (bf16 1e-3), the running
statistics atol 1e-6 and equal on every rank, the parameters after the
step atol 1e-6 in f64 and for the f32 ConvLSTM (in f32 Adam's first step
moves a parameter whose gradient is near its eps 1e-8 by up to lr, so
the pix2pix and UNet parameters are held through their gradients).  The
conv biases ahead of a
training-mode BatchNorm (every UNet block's ``conv1/b`` and ``conv2/b``)
have a zero gradient in exact arithmetic: their gradients are rounding
noise, which Adam turns into steps of about lr of either sign, so they are
held through their gradients, below 1e-6 of the largest gradient, and not
through their values (as tests/test_torch_dp_stateful.py holds them).
Against JAX: the UNet and pix2pix in f64 (in f32 JAX's own UNet gradient
is up to 3.7e-2 of a leaf's largest from its f64 value; the port's
single-device pix2pix gradient in f32 is up to 2.5 times a deep leaf's
largest from its f64 value at this width: its InstanceNorms over 2 x 2
maps amplify rounding, so two f32 orders of summation need not agree
there), the ConvLSTM in f32, dropout off; the
JAX gradient is read from Adam's first moment after its one step (beta1
0.5: mu = g / 2 exactly).  The eval step's per-sample scores atol 1e-5
(f32) of the single-device eval step's.  One epoch of ``fit`` on a UNet
over (1, 2, 2) against the single-device ``fit``: the epoch's loss and
training R^2 rtol 1e-5, the parameters atol 1e-5 (as the one-step
parameters of tests/test_torch_dp_stateful.py: over the epoch's steps
Adam turns the f32 gradients' differences on elements near its eps into
parameter differences of about 1e-6), the running variances atol 1e-6;
the noise biases and the running means, which carry them, within 2 lr per
step taken, and so the validation R^2, which evaluates through those
running means, atol 1e-4 (as tests/test_torch_unet.py holds ``fit``'s
against JAX's).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import Normalizer as JNormalizer  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu.parallel.spatial import (  # noqa: E402
    make_spatial_train_step as j_make_spatial_train_step,
)
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import (  # noqa: E402
    Normalizer,
    SequenceDataset,
    SingleStepDataset,
)
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.parallel.halo import halves  # noqa: E402
from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import (  # noqa: E402
    fit,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

import torch_train_ranks as ranks  # noqa: E402

LR, BETAS = 1e-3, (0.5, 0.999)
MESHES = [(1, 2, 2), (2, 1, 2), (1, 1, 4)]
FEATS = (4, 8, 16, 32)
LSTM = dict(in_channels=5, hidden_channels=(4, 4), kernel_sizes=(5, 3),
            precompute_input_conv=True)
UNET = dict(in_channels=5, unet_features=FEATS)
PIX = dict(in_channels=5, pix2pix_features=4)
MODELS = {  # name: (model, kw, padded, grid, data, batch, dtype, dropout seed)
    "lstm": ("LSTM-h", LSTM, (20, 28), (16, 24), dict(T=40, H=16, W=24, seed=2), 8,
             "float32", None),
    "lstm-bf16": ("LSTM-h", dict(LSTM, compute_dtype="bfloat16"), (20, 28), (16, 24),
                  dict(T=40, H=16, W=24, seed=2), 8, "float32", None),
    "unet": ("UNet-s", UNET, (32, 64), (24, 40), dict(T=40, H=24, W=40, seed=7), 4,
             "float32", None),
    "unet-f64": ("UNet-s", UNET, (32, 64), (24, 40), dict(T=40, H=24, W=40, seed=7), 4,
                 "float64", None),
    "unet-gather": ("UNet-s", UNET, (32, 48), (24, 40), dict(T=40, H=24, W=40, seed=7), 4,
                    "float32", None),
    "unet-gather-f64": ("UNet-s", UNET, (32, 48), (24, 40), dict(T=40, H=24, W=40, seed=7),
                        4, "float64", None),
    "pix2pix": ("PIX2PIX-s", PIX, (256, 256), (200, 240), dict(T=30, H=200, W=240, seed=8),
                4, "float32", 11),
    "pix2pix-f64": ("PIX2PIX-s", PIX, (256, 256), (200, 240),
                    dict(T=30, H=200, W=240, seed=8), 4, "float64", None),
}
GATHER_MESH = (1, 1, 4)
RUNS = [(name, dims) for dims in MESHES for name in MODELS if "gather" not in name]
RUNS += [("unet-gather", GATHER_MESH), ("unet-gather-f64", GATHER_MESH)]
# against JAX's GSPMD step: the ConvLSTM in f32, the UNet and pix2pix in f64,
# dropout off
JAX_RUNS = [(name, dims) for name, dims in RUNS
            if name in ("lstm", "unet-f64", "unet-gather-f64", "pix2pix-f64")]
GRAD_TOL, GRAD_TOL_F64, GRAD_TOL_BF16 = 1e-4, 1e-10, 5e-2
# (run, mesh): the leaves (by path prefix) where JAX's GSPMD step's gradient
# is not JAX's own single-device gradient of the same loss, in this JAX on
# its CPU devices; the port's equals the single-device one everywhere
JAX_GSPMD_OFF = {
    ("lstm", (2, 1, 2)): ("cells/0/w_x",),
    ("unet-f64", (1, 2, 2)): ("enc", "bottleneck/bn1/", "bottleneck/conv"),
    ("pix2pix-f64", (2, 1, 2)): ("initial/", "enc", "bottleneck/", "dec1/"),
    ("pix2pix-f64", (1, 1, 4)): ("dec2/w",),
}
NOISE = ("conv1/b", "conv2/b")  # conv biases ahead of BatchNorm: zero gradient
FIT = dict(model="UNet-fit", in_channels=5, unet_features=FEATS, input_size=(32, 64),
           batch_size=4, num_epochs=1, checkpoint_every=0, seed=3)
FIT_DATA = dict(T=40, H=24, W=40, seed=7)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


@pytest.fixture(scope="module")
def cases():
    """Each model's weights (the port's init, in the JAX layout), state,
    normalizer statistics and global batch."""
    out = {}
    for name, (model, kw, padded, grid, data, bs, dtype, seed) in MODELS.items():
        d = synthetic_e33oma_90d(**data)
        if model.startswith("LSTM"):
            ds = SequenceDataset(d, period="train", sequence_length=3)
        else:
            ds = SingleStepDataset(d, period="train")
        xs, ys = zip(*(ds[i] for i in range(bs)))
        params, state = build_model(model, **kw).init(torch.Generator().manual_seed(3), "cpu")
        n = ds.normalizer
        out[name] = dict(model=model, kw=kw, geo=dict(padded_shape=padded, grid_shape=grid),
                         dtype=dtype, seed=seed, params=bridge.params_to_jax(params),
                         state=None if state is None else bridge.params_to_jax(state),
                         norm=(np.asarray(n.x_mean), np.asarray(n.x_std), float(n.y_mean),
                               float(n.y_std)),
                         batch=(np.stack(xs), np.stack(ys)), paths=bridge.tree_paths(params))
    return out


@pytest.fixture(scope="module")
def fit_case():
    bundle = build_model(FIT["model"], **UNET)
    params, state = bundle.init(torch.Generator().manual_seed(5), "cpu")
    return dict(params=bridge.params_to_jax(params), state=bridge.params_to_jax(state))


@pytest.fixture(scope="module")
def world(cases, fit_case, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("fit"))
    case = dict(cases, opt=(LR, BETAS), runs=RUNS, fit=dict(
        data=FIT_DATA, dims=(1, 2, 2), kw=UNET, config=dict(FIT, snapshot_dir=snap),
        **fit_case))
    return launch.spawn(ranks.spatial_families_world, 4, "cpu", case, timeout=600)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _single_device(c):
    """The port's single-device eval scores at the initial weights, then its
    step on the global batch: (scores, loss, params, grads, state)."""
    bundle = build_model(c["model"], **c["kw"])
    dtype = np.dtype(c["dtype"])
    params = bridge.params_from_jax(_cast(c["params"], dtype))
    for t in param_leaves(params):
        t.requires_grad_(True)
    state = None if c["state"] is None else bridge.params_from_jax(_cast(c["state"], dtype))
    norm = Normalizer(*c["norm"])
    batch = _cast(c["batch"], dtype)
    scores, _ = make_eval_step(bundle, norm, **c["geo"])(params, state, *batch)
    step = make_train_step(bundle, norm, make_optimizer(params, LR, BETAS), **c["geo"])
    rng = None if c["seed"] is None else torch.Generator().manual_seed(c["seed"])
    new_state, m = step(params, state, *batch, rng)
    return (scores.numpy(), m["loss"].item(), [t.detach().numpy() for t in param_leaves(params)],
            [t.grad.numpy() for t in param_leaves(params)],
            [t.numpy() for t in bridge.tree_leaves(new_state)])


@pytest.fixture(scope="module")
def single(cases):
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _single_device(cases[name])
        return memo[name]
    return get


def _tol(name):
    if name.endswith("f64"):
        return GRAD_TOL_F64
    return GRAD_TOL_BF16 if name.endswith("bf16") else GRAD_TOL


def _hold_grads(paths, got, want, tol, of_model=False):
    """Per leaf max |got - want| within ``tol`` of the leaf's largest |want|
    (of the model's largest with ``of_model``); the noise leaves below 1e-6
    of the largest gradient in both."""
    scale = max(np.max(np.abs(g)) for g in want)
    for path, a, b in zip(paths, got, want):
        if path.endswith(NOISE):
            assert max(np.max(np.abs(a)), np.max(np.abs(b))) <= 1e-6 * scale, path
        else:
            err = np.max(np.abs(a - b)) / (scale if of_model else np.max(np.abs(b)))
            assert err <= tol, (path, err)


@pytest.mark.parametrize("name,dims", RUNS, ids=_ids)
def test_spatial_step_matches_single_device(cases, single, world, name, dims):
    """One sharded step against the port's single-device step on the global
    batch, per leaf; the parameters after it, the running statistics and
    the loss; every rank ends with the same parameters and state."""
    c = cases[name]
    got = world[0][(name, dims)]
    _, loss, params, grads, state = single(name)
    assert got["loss"] == pytest.approx(loss, rel=1e-5 if c["kw"].get(
        "compute_dtype") != "bfloat16" else 1e-3)
    # the f32 UNet's small leaves are sums that cancel (module docstring)
    _hold_grads(c["paths"], got["grads"], grads, _tol(name),
                of_model=name in ("unet", "unet-gather"))
    if name == "lstm" or name.endswith("f64"):
        for path, a, b in zip(c["paths"], got["params"], params):
            if not path.endswith(NOISE):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=path)
    assert len(got["state"]) == len(state) == (36 if name.startswith("unet") else 0)
    for a, b in zip(got["state"], state):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for r in world[1:]:
        for key in ("params", "state"):
            for a, b in zip(r[(name, dims)][key], got[key]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,dims", [r for r in RUNS if not r[0].endswith(("bf16", "f64"))],
                         ids=_ids)
def test_spatial_eval_step_matches_single_device(single, world, name, dims):
    """The sharded eval step's per-sample R^2 of the global batch (the
    forward on tiles, the UNet normalizing by its running statistics)
    against the single-device eval step's, on every rank."""
    want = single(name)[0]
    for r in world:
        np.testing.assert_allclose(r[(name, dims)]["scores"], want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_steps(cases):
    """JAX's GSPMD spatial step on each of JAX_RUNS' meshes from the shared
    weights (loss, gradients from Adam's first moment, new state), and
    JAX's single-device gradient of the same loss (``make_loss_fn``)."""
    out = {}
    for name, dims in JAX_RUNS:
        c = cases[name]
        dtype = np.dtype(c["dtype"])
        with jax.enable_x64(dtype == np.float64):
            bundle = j_build_model(c["model"], **c["kw"])
            norm = JNormalizer(*c["norm"])
            opt = jloop.make_optimizer(LR, BETAS)
            mesh = jmesh.make_mesh(*dims, devices=jax.devices()[: int(np.prod(dims))])
            step = j_make_spatial_train_step(bundle, norm, opt, mesh, **c["geo"])
            params = _cast(c["params"], dtype)
            state = None if c["state"] is None else _cast(c["state"], dtype)
            batch = _cast(c["batch"], dtype)
            _, s, o, m = step(params, state, opt.init(params), *batch, None)
            mu = o.inner_state[0].mu
            x, y = jloop._device_preprocess(*batch, norm, c["geo"]["padded_shape"], None)
            loss_fn = jloop.make_loss_fn(bundle, c["geo"]["grid_shape"])
            g = jax.jit(jax.grad(lambda p, st: loss_fn(p, st, x, y, None)[0]))(params, state)
            out[(name, dims)] = dict(
                loss=float(m["loss"]),
                gspmd=[np.asarray(v) / (1 - BETAS[0]) for v in jax.tree.leaves(mu)],
                single=[np.asarray(v) for v in jax.tree.leaves(g)],
                state=[np.asarray(a) for a in jax.tree.leaves(s)])
    return out


def _off(paths, got, want, tol):
    """The leaves (noise leaves aside) whose max |got - want| exceeds
    ``tol`` of the leaf's largest |want|."""
    return {path for path, a, b in zip(paths, got, want) if not path.endswith(NOISE)
            and np.max(np.abs(a - b)) > tol * np.max(np.abs(b))}


@pytest.mark.parametrize("name,dims", JAX_RUNS, ids=_ids)
def test_spatial_step_matches_jax_spatial_step(cases, world, jax_steps, name, dims):
    """Against the JAX package's GSPMD ``make_spatial_train_step`` on a mesh
    of the same shape: the loss, the state, and per leaf the gradients,
    which are JAX's single-device gradient of the same loss.  On some
    meshes XLA's partitioning of the GSPMD step gives a few leaves
    gradients unlike its own single-device ones (JAX_GSPMD_OFF): there the
    port follows JAX's single-device gradient, and every other leaf both."""
    c = cases[name]
    j = jax_steps[(name, dims)]
    got = world[0][(name, dims)]
    assert got["loss"] == pytest.approx(j["loss"], rel=1e-4 if c["dtype"] == "float32" else 1e-10)
    _hold_grads(c["paths"], got["grads"], j["single"], _tol(name))
    prefixes = JAX_GSPMD_OFF.get((name, dims))
    off = {p for p in c["paths"] if prefixes and p.startswith(prefixes)
           and not p.endswith(NOISE)}
    assert _off(c["paths"], j["gspmd"], j["single"], _tol(name)) == off
    assert _off(c["paths"], got["grads"], j["gspmd"], _tol(name)) == off
    for a, b in zip(got["state"], j["state"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_the_gather_rule_runs():
    """Which levels run whole: 32 x 64 over (1, 2, 2) gathers before the
    fourth pool, 32 x 48 over (1, 1, 4) before the third, 256 x 256 over (2,
    2) before the 1-pixel level, 32 x 64 over (2, 1, 2) never."""
    def first_whole(shape, tiles, levels):
        h = torch.zeros((1, shape[0] // tiles[0], shape[1] // tiles[1], 1))
        for level in range(levels):
            if not halves(h):
                return level
            h = h[:, ::2, ::2]
        return None
    assert first_whole((32, 64), (2, 2), 4) == 3
    assert first_whole((32, 48), (1, 4), 4) == 2
    assert first_whole((256, 256), (2, 2), 8) == 6
    assert first_whole((32, 64), (1, 2), 4) is None


def test_fit_over_a_spatial_mesh_trains_a_unet(world, fit_case, tmp_path):
    """One epoch of ``fit`` on a UNet over a (1, 2, 2) mesh (every rank the
    whole batch, the BatchNorm state threaded, validation on tiles) against
    ``fit`` on one device from the same weights and state."""
    got = world[0]["fit"]
    data = synthetic_e33oma_90d(**FIT_DATA)
    ds, val = (SingleStepDataset(data, period=p) for p in ("train", "val"))
    params = bridge.params_from_jax(fit_case["params"])
    for t in param_leaves(params):
        t.requires_grad_(True)
    want = fit(build_model(FIT["model"], **UNET), ds, val,
               TrainConfig(**FIT, snapshot_dir=str(tmp_path)), device="cpu",
               init_params=params, init_state=bridge.params_from_jax(fit_case["state"]),
               verbose=False)
    for key in ("MSELoss", "r2_score"):
        np.testing.assert_allclose(got["logger"][key], want["logger"][key], rtol=1e-5)
    np.testing.assert_allclose(got["logger"]["r2_score_val"], want["logger"]["r2_score_val"],
                               rtol=0, atol=1e-4)
    steps = len(ds) // FIT["batch_size"]
    noise = 2 * LR * steps
    for path, a, b in zip(bridge.tree_paths(params), got["params"], param_leaves(want["params"])):
        atol = noise if path.endswith(NOISE) else 1e-5
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=atol, err_msg=path)
    for path, a, b in zip(bridge.tree_paths(want["state"]), got["state"],
                          bridge.tree_leaves(want["state"])):
        atol = noise if path.endswith("mean") else 1e-6
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=atol, err_msg=path)
