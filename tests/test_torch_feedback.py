"""The closed loop of a 6-channel single-step model (UNet-6ch) against the
JAX package: ``make_feedback_rollout_fn`` (a linear stand-in whose loop
numpy can follow, and the UNet), ``predict_test_feedback`` over a test
split in chunks with a repeat-padded tail, single-step snapshots through
``load_snapshot``, and the evaluation CLI of both packages on one UNet-6ch
snapshot written by the port (its checkpoint read by JAX's loader).

Shapes: UNet features (4, 8, 16, 32), 6 channels, grid 16 x 24 padded to
32 x 32; the synthetic fixture's test split is 12 steps.  Tolerances: the
linear stand-in atol 1e-5 (as the JAX package's own test); UNet
predictions within 1e-4 of their largest magnitude (f32 sums in other
orders, fed back step after step)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data.dataset import Normalizer as JNormalizer  # noqa: E402
from nasa_niswan_tpu.data.dataset import SingleStepDataset as JSingleStep  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as j_synthetic  # noqa: E402
from nasa_niswan_tpu.evalx import evaluate as jeval  # noqa: E402
from nasa_niswan_tpu.evalx.__main__ import main as j_eval_main  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jar  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer, SingleStepDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.evalx import evaluate as teval  # noqa: E402
from nasa_niswan_tpu_torch.evalx.__main__ import main as t_eval_main  # noqa: E402
from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.rollout import autoregressive as tar  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402

from test_torch_unet import batch_statistics  # noqa: E402

FEATS = (4, 8, 16, 32)
GRID, PADDED = (16, 24), (32, 32)
TOL = 1e-4

# single-step snapshots of seeded weights: UNet-6ch on the 16 x 24 fixture,
# PIX2PIX on a 90 x 144 one (its maps are padded to 256 x 256)
SNAPSHOTS = {
    "UNet-clisnap": dict(in_channels=6, unet_features=FEATS, input_size=PADDED,
                         synthetic_steps=60, synthetic_grid=GRID),
    "PIX2PIX-clisnap": dict(pix2pix_features=4, input_size=(256, 256),
                            synthetic_steps=24, synthetic_grid=(90, 144)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def single_step_snapshot(run_dir: str, model: str) -> str:
    """configurations.json + epoch-001/ for ``model`` (a key of SNAPSHOTS):
    seeded weights and, for the UNet, BatchNorm statistics of a random
    batch, written by the port's save_checkpoint."""
    cfg = TrainConfig(model=model, snapshot_dir=run_dir, device="cpu", **SNAPSHOTS[model])
    cfg.dump()
    bundle = build_model(model, in_channels=cfg.in_channels,
                         unet_features=cfg.unet_features,
                         pix2pix_features=cfg.pix2pix_features)
    params, state = bundle.init(torch.Generator().manual_seed(0), "cpu")
    if state is not None:
        x = torch.randn((2, *cfg.input_size, cfg.in_channels),
                        generator=torch.Generator().manual_seed(1))
        state = batch_statistics(bundle.apply, params, state, x)
    save_checkpoint(os.path.join(run_dir, "epoch-001"), params, epoch=1, model_state=state)
    return run_dir


def _close(got, want, rel=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _norms(seed):
    rng = np.random.default_rng(seed)
    kw = dict(x_mean=rng.uniform(-0.2, 0.3, 6).astype(np.float32),
              x_std=rng.uniform(0.8, 1.4, 6).astype(np.float32), y_mean=0.1, y_std=2.0)
    return JNormalizer(**kw), Normalizer(**kw)


def test_feedback_rollout_with_a_linear_model_matches_jax():
    w = np.linspace(0.1, 0.7, 6, dtype=np.float32)
    jnorm, tnorm = _norms(0)
    forcings = np.random.default_rng(1).standard_normal((2, 4, 6, 12, 16)).astype(np.float32)
    want = jar.make_feedback_rollout_fn(
        lambda p, x: jnp.sum(x * w, axis=-1, keepdims=True), jnorm,
        padded_shape=(16, 20), grid_shape=(12, 16))(None, jnp.asarray(forcings))
    got = tar.make_feedback_rollout_fn(
        lambda p, x: torch.sum(x * torch.from_numpy(w), dim=-1, keepdim=True), tnorm,
        padded_shape=(16, 20), grid_shape=(12, 16))(None, forcings)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def unet6():
    bundle = build_model("UNet-fb", in_channels=6, unet_features=FEATS)
    params, state = bundle.init(torch.Generator().manual_seed(2), "cpu")
    x = torch.randn((2, *PADDED, 6), generator=torch.Generator().manual_seed(3))
    state = batch_statistics(bundle.apply, params, state, x)
    jbundle = j_build_model("UNet-fb", in_channels=6, unet_features=FEATS)
    return bundle, params, state, jbundle, bridge.params_to_jax(params), \
        bridge.params_to_jax(state)


def test_feedback_rollout_with_the_unet_matches_jax(unet6):
    bundle, params, state, jbundle, jp, js = unet6
    jnorm, tnorm = _norms(4)
    forcings = np.random.default_rng(5).standard_normal((2, 4, 6, *GRID)).astype(np.float32)
    want = jar.make_feedback_rollout_fn(
        lambda p, x: jbundle.apply(p, js, x)[0], jnorm, padded_shape=PADDED,
        grid_shape=GRID)(jp, jnp.asarray(forcings))
    got = tar.make_feedback_rollout_fn(
        lambda p, x: bundle.apply(p, state, x)[0], tnorm, padded_shape=PADDED,
        grid_shape=GRID)(params, forcings)
    _close(got, want)


@pytest.fixture(scope="module")
def test_split():
    tds = SingleStepDataset(synthetic_e33oma_90d(T=60, H=16, W=24, seed=7), period="test",
                            in_channels=6)
    jds = JSingleStep(j_synthetic(T=60, H=16, W=24, seed=7), period="test", in_channels=6)
    return tds, jds


@pytest.mark.parametrize("chunk", [5, 12])
def test_predict_test_feedback_matches_jax(unet6, test_split, chunk):
    """12 steps in chunks of 5 (a repeat-padded tail) and in one chunk;
    the chunked loop also equals the one-shot feedback rollout, and the
    BatchNorm state comes back unchanged."""
    bundle, params, state, jbundle, jp, js = unet6
    tds, jds = test_split
    want = jeval.predict_test_feedback(jbundle, jp, js, jds, padded_shape=PADDED,
                                       chunk_steps=chunk)
    got = teval.predict_test_feedback(bundle, params, state, tds, padded_shape=PADDED,
                                      chunk_steps=chunk)
    np.testing.assert_array_equal(got["GTs"], want["GTs"])
    assert got["PDs"].shape == (12, *GRID)
    _close(got["PDs"], want["PDs"])
    frames, _ = tds.feedback_stream()
    one = tar.make_feedback_rollout_fn(
        lambda p, x: bundle.apply(p, state, x)[0], tds.normalizer, padded_shape=PADDED,
        grid_shape=GRID)(params, frames[None])[0]
    np.testing.assert_allclose(got["PDs"], one.numpy(), rtol=0, atol=1e-6)


def test_feedback_chunk_carries_state_and_feedback(unet6, test_split):
    """One chunk hands back the state it was given and its last prediction
    as the next feedback frame; on the CPU the chunk runs no graph."""
    bundle, params, state, *_ = unet6
    tds, _ = test_split
    frames, _ = tds.feedback_stream()
    run = teval.make_feedback_chunk(bundle, tds.normalizer, padded_shape=PADDED,
                                    grid_shape=GRID)
    prev0 = torch.from_numpy(frames[0, 5].copy())
    st, prev, preds = run(params, state, prev0, frames[:4])
    st_e, prev_e, preds_e = run.eager(params, state, prev0, frames[:4])
    assert st is state and torch.equal(prev, preds[-1]) and torch.equal(preds, preds_e)
    assert run.runner.captures == 0
    with pytest.raises(ValueError, match="in_channels=6"):
        teval.predict_test_feedback(
            bundle, params, state,
            SingleStepDataset(synthetic_e33oma_90d(T=60, H=16, W=24, seed=7),
                              period="test"), padded_shape=PADDED)


@pytest.mark.parametrize("model", list(SNAPSHOTS))
def test_load_snapshot_of_a_single_step_model(tmp_path, model):
    run_dir = single_step_snapshot(str(tmp_path / "s"), model)
    snap = load_snapshot(run_dir, device="cpu")
    assert not snap.bundle.is_sequence and not snap.closed_loop
    assert snap.feedback_single == (model == "UNet-clisnap")
    assert snap.static is None and snap.meta["epoch"] == 1
    assert isinstance(snap.dataset, SingleStepDataset) and snap.dataset.period == "test"
    if model == "UNet-clisnap":
        assert snap.bundle.config.features == FEATS and snap.cfg.in_channels == 6
        assert len(bridge.tree_leaves(snap.eval_state)) == 36
        assert all(t.min() > 0 for t in bridge.tree_leaves(snap.eval_state)[1::2])
    else:
        assert snap.bundle.config.features == 4 and snap.eval_state is None


def test_evaluation_clis_agree_on_a_unet6_snapshot(tmp_path):
    """The port's evaluation CLI and the JAX package's on one UNet-6ch
    snapshot written by the port: both run the closed loop and write the
    same test-results.npy (within TOL) and the same report."""
    runs = {}
    for name, main in (("jax", j_eval_main), ("port", t_eval_main)):
        run_dir = single_step_snapshot(str(tmp_path / name), "UNet-clisnap")
        argv = ["--run-dir", run_dir] + (["--device", "cpu"] if name == "port" else [])
        runs[name] = main(argv), teval.load_test_results(
            os.path.join(run_dir, "test-results.npy"))
    (j_report, (j_gts, j_pds)), (t_report, (t_gts, t_pds)) = runs["jax"], runs["port"]
    np.testing.assert_array_equal(t_gts, j_gts)
    _close(t_pds, j_pds)
    np.testing.assert_allclose(t_report["global_r2"], j_report["global_r2"], rtol=0,
                               atol=1e-4)
    with pytest.raises(SystemExit, match="closed-loop"):
        t_eval_main(["--run-dir", str(tmp_path / "port"), "--device", "cpu", "--oat"])
