"""The port's spatially sharded training (nasa_niswan_tpu_torch/parallel/:
the halo exchange's backward, ``make_spatial_train_step`` on both training
routes, ``fit`` over a (dp, lat, lon) mesh) on gloo ranks, against dense
constructions, the JAX package's single-device ``make_train_step`` and its
GSPMD ``make_spatial_train_step`` on a mesh of the same shape (the 8 CPU
devices of tests/conftest.py).

One world of four ranks is spawned once (tests/torch_train_ranks.py) and
lays out every mesh: (1, 2, 2), (1, 1, 4) (a lon ring of four) and (1, 4,
1) (a lon ring of one) for the halo exchange, (1, 2, 2) and (2, 1, 2) for
the step.  The step's setup is ``tiny_setup`` of tests/test_parallel.py: a
16 x 24 grid padded to 20 x 28, C = 5, hidden (4,), k 3, T 3, batch 8,
f32.

Tolerances: the halo's adjoint identity <E x, y> = <x, E^T y> to 1e-5
relative, E^T by autograd equal to ``halo_exchange_zero_transpose`` bit for
bit; ``sharded_conv2d``'s gradients within 1e-5 of the dense conv's largest
entry; the step against JAX, JAX's own limits for its spatial step (loss
rel 1e-4, head weights atol 1e-5 after one step) and R^2 atol 1e-5; every
parameter against the port's single-device step atol 1e-6 (one Adam step of
lr 1e-3 moves each by about 1e-3 whatever the gradient's rounding), so
the gradients themselves are held per leaf, within 1e-4 of the leaf's
largest, against both the port's single-device step and JAX's gradient of
the same loss (a leaf summed over the tiles twice, or a wrong dp divisor,
is off by O(1)); the epoch of ``fit`` against the single-device ``fit``, loss and R^2 rtol 1e-5,
parameters atol 1e-6."""

import types

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import SequenceDataset as JSequenceDataset  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as j_synthetic  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu.parallel.spatial import (  # noqa: E402
    make_spatial_train_step as j_make_spatial_train_step,
)
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer, SequenceDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.ops.conv import conv2d  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.parallel.spatial import make_spatial_train_step  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import fit, make_optimizer, make_train_step  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402

GRID, PADDED = (16, 24), (20, 28)
GEO = dict(padded_shape=PADDED, grid_shape=GRID)
MODEL = dict(in_channels=5, hidden_channels=(4,), kernel_sizes=(3,))
LR, BETAS = 1e-3, (0.5, 0.999)
DATA = dict(T=40, seed=2, H=GRID[0], W=GRID[1])
SEQ = 3
HALO_MESHES = [(1, 2, 2), (1, 1, 4), (1, 4, 1)]
STEP_MESHES = [(1, 2, 2), (2, 1, 2)]
ROUTES = ["remat", "per-cell"]
GRAD_TOL = 1e-4  # per leaf, of the leaf's largest (measured up to 2.5e-6)
FIT = dict(model="LSTM-t", in_channels=5, hidden_channels=(4,), kernel_size=(3,),
           num_layers=1, batch_size=4, sequence_length=SEQ, num_epochs=1,
           input_size=PADDED, checkpoint_every=0, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    """``tiny_setup``: the dataset, the JAX bundle's initial weights and the
    batch of its first 8 windows."""
    ds = JSequenceDataset(j_synthetic(**DATA), period="train", sequence_length=SEQ)
    bundle = j_build_model("LSTM-t", **MODEL)
    params, _ = bundle.init(jax.random.PRNGKey(0))
    xs, ys = zip(*(ds[i] for i in range(8)))
    n = ds.normalizer
    return dict(ds=ds, bundle=bundle, params=jax.tree.map(np.asarray, params),
                batch=(np.stack(xs), np.stack(ys)),
                norm=(np.asarray(n.x_mean), np.asarray(n.x_std), float(n.y_mean),
                      float(n.y_std)))


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's single-device step from the shared weights: (loss, R^2,
    parameters after it)."""
    opt = jloop.make_optimizer(LR, BETAS)
    step = jloop.make_train_step(setup["bundle"], setup["ds"].normalizer, opt, **GEO)
    p, _, _, m = step(setup["params"], None, opt.init(setup["params"]), *setup["batch"],
                      jax.random.PRNGKey(7))
    return float(m["loss"]), float(m["r2"]), jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def fit_cfg(tmp_path_factory):
    """``FIT`` with a snapshot directory of the test's own (``fit`` writes
    logger.npy there)."""
    return dict(FIT, snapshot_dir=str(tmp_path_factory.mktemp("fit")))


@pytest.fixture(scope="module")
def world(setup, fit_cfg):
    """Every rank's results: one world of four ranks runs every mesh."""
    rng = np.random.default_rng(4)
    halo = dict(x=rng.standard_normal((2, *PADDED, 3)).astype(np.float32),
                g=rng.standard_normal((2, *PADDED, 7)).astype(np.float32),
                conv=((0.1 * rng.standard_normal((3, 3, 3, 7))).astype(np.float32),
                      rng.standard_normal(7).astype(np.float32)))
    step = dict(norm=setup["norm"], model=MODEL, params=setup["params"], opt=(LR, BETAS),
                geo=GEO, batch=setup["batch"], data=DATA, seq=SEQ, fit=fit_cfg)
    results = launch.spawn(ranks.spatial_world, 4, "cpu", dict(
        halo=halo, step=step, halo_meshes=HALO_MESHES, step_meshes=STEP_MESHES),
        timeout=300)
    return halo, results


@pytest.fixture(scope="module")
def halo_world(world):
    halo, results = world
    return lambda dims: (halo, [r["halo"][dims] for r in results])


@pytest.fixture(scope="module")
def step_world(world):
    return lambda dims: [r["step"][dims] for r in world[1]]


def _ids(dims):
    return "x".join(map(str, dims))


@pytest.mark.parametrize("dims", HALO_MESHES, ids=_ids)
@pytest.mark.parametrize("kind", ["zero", "geo"])
def test_halo_backward_is_the_adjoint(halo_world, dims, kind):
    """<E x, y> = <x, E^T y> summed over the ranks, pads 1 and 2; the zero
    halo's E^T by autograd is ``halo_exchange_zero_transpose``."""
    _, results = halo_world(dims)
    for pad in (1, 2):
        lhs, rhs = results[0][(kind, pad)]
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (pad, lhs, rhs)
    assert all(r["transpose_all"] for r in results)


@pytest.mark.parametrize("dims", HALO_MESHES, ids=_ids)
def test_sharded_conv2d_gradient_matches_dense(halo_world, dims):
    case, results = halo_world(dims)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    k, b = (torch.from_numpy(a).requires_grad_(True) for a in case["conv"])
    out = conv2d(x, k, b, padding=1)
    want = torch.autograd.grad((out * torch.from_numpy(case["g"])).sum(), (x, k, b))
    for got, w in zip(results[0]["conv"], want):
        w = w.numpy()
        assert got.shape == w.shape
        assert np.max(np.abs(got - w)) <= 1e-5 * np.max(np.abs(w))


def _port_single(setup, remat, grads=False):
    """The port's single-device step: (loss, parameters after it[, their
    gradients])."""
    params = bridge.params_from_jax(setup["params"])
    for t in param_leaves(params):
        t.requires_grad_(True)
    opt = make_optimizer(params, LR, BETAS)
    step = make_train_step(build_model("LSTM-t", remat=remat, **MODEL),
                           Normalizer(*setup["norm"]), opt, **GEO)
    _, m = step(params, None, *setup["batch"])
    out = m["loss"].item(), [t.detach().numpy() for t in param_leaves(params)]
    return out + ([t.grad.numpy() for t in param_leaves(params)],) if grads else out


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's gradient of the training loss (``make_loss_fn``) at the shared
    weights on the batch, in the port's leaf order."""
    x, y = jloop._device_preprocess(*setup["batch"], setup["ds"].normalizer, PADDED, None)
    loss_fn = jloop.make_loss_fn(setup["bundle"], GRID)
    g = jax.jit(jax.grad(lambda p: loss_fn(p, None, x, y, None)[0]))(setup["params"])
    return [t.numpy() for t in param_leaves(bridge.params_from_jax(jax.tree.map(np.asarray, g)))]


@pytest.mark.parametrize("dims", STEP_MESHES, ids=_ids)
@pytest.mark.parametrize("route", ROUTES)
def test_spatial_step_gradients_match_per_leaf(setup, jax_grads, step_world, dims, route):
    """The sharded step's all-reduced gradients (summed over lat and lon,
    averaged over dp), leaf by leaf relative to the leaf's largest, against
    the port's single-device step and JAX's gradient of the same loss
    (GRAD_TOL); the parameters after the step beside them."""
    got = step_world(dims)[0][route]
    loss, params, grads = _port_single(setup, route == "remat", grads=True)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    for want in (grads, jax_grads):
        for i, (a, b) in enumerate(zip(got["grads"], want)):
            assert np.max(np.abs(a - b)) <= GRAD_TOL * np.max(np.abs(b)), (i, a, b)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dims", STEP_MESHES, ids=_ids)
@pytest.mark.parametrize("route", ROUTES)
def test_spatial_step_matches_jax_single_device(setup, jax_step, step_world, dims, route):
    """The sharded step on both routes against JAX's single-device step on
    the same weights and batch, and against the port's own; every rank
    ends with the same parameters."""
    results = step_world(dims)
    got = results[0][route]
    loss, r2, jparams = jax_step
    assert got["loss"] == pytest.approx(loss, rel=1e-4)
    assert got["r2"] == pytest.approx(r2, abs=1e-5)
    head = bridge.params_from_jax(jparams)["head"]
    names = [n for n in ("b", "w")]  # the head's leaves, last in param_leaves order
    for name, a in zip(names, got["params"][-2:]):
        np.testing.assert_allclose(a, head[name].numpy(), atol=1e-5)
    one_loss, one_params = _port_single(setup, route == "remat")
    assert got["loss"] == pytest.approx(one_loss, rel=1e-5)
    for a, b in zip(got["params"], one_params):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for r in results[1:]:
        for a, b in zip(r[route]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", STEP_MESHES, ids=_ids)
def test_spatial_step_matches_jax_spatial_step(setup, step_world, dims):
    """Against the JAX package's GSPMD ``make_spatial_train_step`` on a mesh
    of the same shape."""
    if jax.device_count() < int(np.prod(dims)):
        pytest.skip(f"{jax.device_count()} JAX devices, the mesh needs {np.prod(dims)}")
    opt = jloop.make_optimizer(LR, BETAS)
    mesh = jmesh.make_mesh(*dims, devices=jax.devices()[: int(np.prod(dims))])
    step = j_make_spatial_train_step(setup["bundle"], setup["ds"].normalizer, opt, mesh,
                                     **GEO)
    p, _, _, m = step(setup["params"], None, opt.init(setup["params"]), *setup["batch"],
                      jax.random.PRNGKey(7))
    head = bridge.params_from_jax(jax.tree.map(np.asarray, p))["head"]
    for route in ROUTES:
        got = step_world(dims)[0][route]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
        for name, a in zip(("b", "w"), got["params"][-2:]):
            np.testing.assert_allclose(a, head[name].numpy(), atol=1e-5)


def test_fit_over_a_spatial_mesh_matches_one_device(step_world, tmp_path):
    """One epoch of ``fit`` on a (1, 2, 2) mesh (every rank the whole
    batch, validation through ``convlstm_apply_sharded``) against ``fit``
    on one device."""
    got = step_world((1, 2, 2))[0]["fit"]
    data = synthetic_e33oma_90d(**DATA)
    ds, val = (SequenceDataset(data, period=p, sequence_length=SEQ) for p in ("train", "val"))
    want = fit(build_model("LSTM-t", **MODEL), ds, val,
               TrainConfig(**FIT, snapshot_dir=str(tmp_path)), device="cpu", verbose=False)
    for key in ("MSELoss", "r2_score", "r2_score_val"):
        np.testing.assert_allclose(got["logger"][key], want["logger"][key], rtol=1e-5)
    for a, b in zip(got["params"], param_leaves(want["params"])):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dims", [(1, 3, 1), (1, 1, 3), (1, 2, 3)], ids=_ids)
def test_spatial_step_refuses_a_grid_it_cannot_tile(dims):
    """Every family is taken, but the padded 20 x 28 grid must split evenly
    over lat and lon: 3 rows or columns of tiles are refused before the
    mesh's groups are read."""
    mesh = types.SimpleNamespace(dp=dims[0], lat=dims[1], lon=dims[2])
    norm = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    for bundle in (build_model("UNet-t", in_channels=5, unet_features=(4, 8, 16, 32)),
                   build_model("PIX2PIX-t", in_channels=5, pix2pix_features=4),
                   build_model("LSTM-t", precompute_input_conv=True, **MODEL)):
        with pytest.raises(ValueError, match="does not tile evenly"):
            make_spatial_train_step(bundle, norm, None, mesh, **GEO)


def test_chip_smoke_two_rank_spatial_phase_on_gloo():
    """chip_smoke.py's two-rank spatial phase (which the card's machine runs
    only with two cards) on two CPU ranks at a small size, f32: the (1, 1,
    2) and (1, 2, 1) sharded steps on the remat, per-cell and hoisted
    routes and the UNet's (f64) against the one-device step."""
    import chip_smoke

    out = launch.spawn(chip_smoke.two_rank_spatial_phase, 2, "cpu", dict(
        grid=GRID, padded=PADDED, hidden=(8, 4), kernels=(5, 3), bs=4, T=4,
        dtype="float32"), timeout=300)
    assert len(out[0]) == 8 and out[1] == {}
    for key, v in out[0].items():
        assert v["loss_rel"] <= 1e-5 and v["grad_rel"] <= 1e-4, (key, v)
        assert v.get("state_rel", 0.0) <= 1e-6, (key, v)
