"""The training slice of the PyTorch port against the JAX package: the
schedule, R^2, the synthetic fixture, ``SequenceDataset``, the train and
eval steps (a 5-step trajectory against JAX's ``make_train_step``),
checkpoints and ``configurations.json`` in both directions, and the
training CLI on the CPU.

Shapes: 2 layers, hidden (4, 3), kernels (3, 3), 7 input channels (5
forcings + 2 static), T = 4, grid (16, 24) padded to (20, 28), batch 3."""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as j_synthetic  # noqa: E402
from nasa_niswan_tpu.evalx.metrics import r2 as j_r2  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.train import checkpoint as jckpt  # noqa: E402
from nasa_niswan_tpu.train import loop as jloop  # noqa: E402
from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu.train.schedule import step_lr as j_step_lr  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data import dataset as tdata  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.evalx.metrics import r2  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model, model_family  # noqa: E402
from nasa_niswan_tpu_torch.train import __main__ as cli  # noqa: E402
from nasa_niswan_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args  # noqa: E402
from nasa_niswan_tpu_torch.train.schedule import step_lr  # noqa: E402

MODEL = dict(in_channels=7, hidden_channels=(4, 3), kernel_sizes=(3, 3))
GEO = dict(padded_shape=(20, 28), grid_shape=(16, 24))
SEQ, BS, LR, BETAS = 4, 3, 1e-3, (0.5, 0.999)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixture():
    data = synthetic_e33oma_90d(T=60, H=16, W=24, seed=7)
    return data, tdata.SequenceDataset(data, period="train", sequence_length=SEQ,
                                       in_channels=7)


def _batch(ds, step):
    idx = np.random.default_rng(step).permutation(len(ds))[:BS]
    xs, ys = zip(*(ds[int(i)] for i in idx))
    return np.stack(xs), np.stack(ys)


def _port_params(jparams):
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    for t in tckpt.param_leaves(params):
        t.requires_grad_(True)
    return params


@pytest.fixture(scope="module")
def jax_run(fixture):
    """5 JAX training steps (XLA cell, remat) from seeded weights, with the
    params and optimizer state after step 2."""
    data, ds = fixture
    bundle = j_build_model("LSTM-p", **MODEL)
    params, state = bundle.init(jax.random.PRNGKey(0))
    opt = jloop.make_optimizer(LR, BETAS)
    opt_state = opt.init(params)
    step = jloop.make_train_step(bundle, ds.normalizer, opt, static=data["static"][:2],
                                 donate=False, **GEO)
    losses, r2s, after2 = [], [], None
    for s in range(5):
        opt_state = jloop.set_learning_rate(opt_state, LR * 0.9 ** (s // 3))
        params, state, opt_state, m = step(params, state, opt_state, *_batch(ds, s),
                                           jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
        r2s.append(float(m["r2"]))
        if s == 1:
            after2 = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state))
    init = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0))[0])
    return {"init": init, "losses": np.array(losses), "r2": np.array(r2s),
            "final": jax.tree.map(np.asarray, params), "after2": after2}


def _port_steps(fixture, params, steps, optimizer=None):
    data, ds = fixture
    bundle = build_model("LSTM-p", **MODEL)
    opt = optimizer or tloop.make_optimizer(params, LR, BETAS)
    step = tloop.make_train_step(bundle, ds.normalizer, opt, static=data["static"][:2], **GEO)
    losses, r2s = [], []
    for s in steps:
        tloop.set_learning_rate(opt, LR * 0.9 ** (s // 3))
        _, m = step(params, None, *_batch(ds, s))
        losses.append(m["loss"].item())
        r2s.append(m["r2"].item())
    return np.array(losses), np.array(r2s), opt


def test_train_trajectory_matches_jax(fixture, jax_run):
    """5 Adam steps with an lr change from the same weights and batches:
    per-step loss rtol 2e-4, as the JAX package's trajectory test holds its
    60 steps; the final weights to rtol 5e-3 / atol 5e-5."""
    params = _port_params(jax_run["init"])
    losses, r2s, _ = _port_steps(fixture, params, range(5))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2e-4)
    np.testing.assert_allclose(r2s, jax_run["r2"], rtol=2e-4, atol=1e-5)
    got = bridge.params_to_jax(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_run["final"])):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)


def test_jax_checkpoint_and_config_resume_in_port(fixture, jax_run, tmp_path):
    """A JAX-written epoch checkpoint (params + Adam moments and count) and
    configurations.json resume in the port: steps 3..5 then match JAX's."""
    jparams, jopt = jax_run["after2"]
    ckpt_dir = str(tmp_path / "epoch-002")
    jckpt.save_checkpoint(ckpt_dir, jparams, jopt, learning_rate=LR, epoch=2)
    path = JTrainConfig(model="LSTM-p", in_channels=7, hidden_channels=(4, 3),
                        kernel_size=(3, 3), num_layers=2, cell_impl="pallas2",
                        dp_devices=2, snapshot_dir=str(tmp_path)).dump()
    cfg = TrainConfig.load(path)
    assert (cfg.in_channels, cfg.hidden_channels, cfg.kernel_size) == (7, (4, 3), (3, 3))
    assert cfg.device == "cuda"  # a JAX file has none: the port's default
    assert tckpt.latest_epoch_dir(str(tmp_path)) == ckpt_dir

    template = build_model("LSTM-p", **MODEL).init(torch.Generator().manual_seed(9))[0]
    params, opt_state, meta = tckpt.load_checkpoint(ckpt_dir, template, lr=5e-4)
    assert meta["epoch"] == 2 and meta["learning_rate"] == 5e-4
    assert opt_state["step"] == 2
    opt = tloop.make_optimizer(params, LR, BETAS)
    tckpt.load_optimizer_state(opt, params, opt_state)
    losses, _, _ = _port_steps(fixture, params, range(2, 5), opt)
    np.testing.assert_allclose(losses, jax_run["losses"][2:], rtol=2e-4)


def test_port_checkpoint_loads_in_jax(fixture, jax_run, tmp_path):
    """The port's checkpoint.npz holds the JAX package's leaves: JAX loads
    params and the optax Adam state (count, mu, nu, lr) leaf for leaf."""
    params = _port_params(jax_run["init"])
    _, _, opt = _port_steps(fixture, params, range(2))
    ckpt_dir = str(tmp_path / "epoch-001")
    tckpt.save_checkpoint(ckpt_dir, params, opt, learning_rate=LR, epoch=1)
    jopt = jloop.make_optimizer(LR, BETAS)
    jparams, jstate, meta = jckpt.load_checkpoint(
        ckpt_dir, jax_run["init"], jopt.init(jax_run["init"])
    )
    assert meta["epoch"] == 1
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(bridge.params_to_jax(params))):
        np.testing.assert_array_equal(a, b)
    adam = jstate.inner_state[0]
    assert int(adam.count) == int(jstate.count) == 2
    assert float(jstate.hyperparams["learning_rate"]) == pytest.approx(LR)
    st = tckpt.optimizer_state(opt, params)
    for want, got in ((st["exp_avg"], adam.mu), (st["exp_avg_sq"], adam.nu)):
        leaves = jax.tree.leaves(got)
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and back into the port, unchanged
    params2, st2, _ = tckpt.load_checkpoint(ckpt_dir, params)
    assert st2["step"] == 2
    for a, b in zip(tckpt.param_leaves(params2), tckpt.param_leaves(params)):
        assert torch.equal(a, b) and a.requires_grad


def test_eval_step_matches_jax(fixture, jax_run):
    """Per-sample R^2 and predictions (physical units) of the eval step."""
    data, ds = fixture
    x, y = _batch(ds, 11)
    jstep = jloop.make_eval_step(j_build_model("LSTM-p", **MODEL), ds.normalizer,
                                 static=data["static"][:2], unnormalize=True, **GEO)
    want_r2, want_p = jstep(jax_run["init"], None, x, y)
    tstep = tloop.make_eval_step(build_model("LSTM-p", **MODEL), ds.normalizer,
                                 static=data["static"][:2], unnormalize=True, **GEO)
    got_r2, got_p = tstep(_port_params(jax_run["init"]), None, x, y)
    assert got_p.grad_fn is None and got_p.shape == (BS, 16, 24)
    np.testing.assert_allclose(got_r2.numpy(), np.asarray(want_r2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-9)


def test_device_window_source_feeds_the_same_batches(fixture):
    """Windows gathered by start index from the resident slab equal the
    dataset's samples, and the device step equals the host step."""
    data, ds = fixture
    src = tloop.DeviceWindowSource(ds, "cpu")
    starts = np.array([0, 5, len(ds) - 1])
    x, y = src.gather(starts)
    for i, s in enumerate(starts):
        want_x, want_y = ds.raw_item(int(s))
        np.testing.assert_array_equal(x[i].numpy(), want_x)
        np.testing.assert_array_equal(y[i].numpy(), want_y)
    bundle = build_model("LSTM-p", **MODEL)
    gen = torch.Generator().manual_seed(2)
    pa, _ = bundle.init(gen)
    pb = {"cells": [{k: v.detach().clone().requires_grad_(True) for k, v in c.items()}
                    for c in pa["cells"]],
          "head": {k: v.detach().clone().requires_grad_(True) for k, v in pa["head"].items()}}
    kw = dict(static=data["static"][:2], **GEO)
    dev = tloop.make_device_train_step(
        bundle, ds.normalizer, tloop.make_optimizer(pa, LR, BETAS), src, **kw)
    host = tloop.make_train_step(
        bundle, ds.normalizer, tloop.make_optimizer(pb, LR, BETAS), **kw)
    for _ in range(2):
        _, m1 = dev(pa, None, starts)
        _, m2 = host(pb, None, x.numpy(), y.numpy())
        assert m1["loss"].item() == m2["loss"].item()


def test_slab_check_raises_when_it_does_not_fit(fixture, monkeypatch):
    """Slabs that do not fit in half the free device memory send ``fit`` to
    the streamed route (it used to raise); on the host they always fit, and
    a dataset without a slab always streams."""
    _, ds = fixture
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1024, 2048))
    assert not tloop.slabs_fit((ds, ds), torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (2**40, 2**40))
    assert tloop.slabs_fit((ds, ds), torch.device("cuda"))
    assert tloop.slabs_fit((ds, ds), torch.device("cpu"))  # no limit on the host
    assert not tloop.slabs_fit((ds, object()), torch.device("cpu"))


def test_cli_trains_on_cpu_writes_logger_and_resumes(tmp_path):
    """``python -m nasa_niswan_tpu_torch.train --device cpu`` end to end:
    configurations.json (readable by the JAX package), epoch checkpoints,
    logger.npy in the reference's three-array format, then --auto-resume
    continues from the newest epoch."""
    snap = str(tmp_path / "snap")
    argv = ["--model", "LSTM-cli", "--device", "cpu", "--num-layers", "2",
            "--hidden-channels", "4", "3", "--kernel-size", "3", "3",
            "--in-channels", "7", "--batch-size", "3", "--sequence-length", "4",
            "--synthetic-steps", "50", "--synthetic-grid", "16", "24",
            "--input-size", "20", "28", "--checkpoint-every", "1",
            "--snapshot-dir", snap]
    cfg = parse_args(argv + ["--num-epochs", "2"])
    cfg.dump()
    out = cli.main(cfg)
    assert JTrainConfig.load(os.path.join(snap, "configurations.json")).in_channels == 7
    with open(os.path.join(snap, "logger.npy"), "rb") as f:
        logs = [np.load(f) for _ in range(3)]
    assert [a.shape for a in logs] == [(2,)] * 3
    np.testing.assert_allclose(logs[0], out["logger"]["MSELoss"])
    assert all(np.isfinite(a).all() for a in logs)
    assert sorted(d for d in os.listdir(snap) if d.startswith("epoch-")) == [
        "epoch-001", "epoch-002"]
    resumed = cli.main(parse_args(argv + ["--num-epochs", "3", "--auto-resume"]))
    assert len(resumed["logger"]["MSELoss"]) == 1
    assert os.path.isdir(os.path.join(snap, "epoch-003"))
    with open(os.path.join(snap, "configurations.json")) as f:
        assert json.load(f)["device"] == "cpu"


def test_cli_device_is_explicit(monkeypatch):
    assert parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TrainConfig(synthetic_steps=60, synthetic_grid=(16, 24)))
    # --levels > 1 fuses the levels (it used to raise): C = 3 * levels + 2
    xs, y = cli.load_data(TrainConfig(levels=2, synthetic_steps=20,
                                      synthetic_grid=(16, 24), device="cpu"))
    assert xs.shape == (20, 8, 16, 24) and y.shape == (20, 16, 24)
    assert TrainConfig(mode="seq2seq", levels=20, device="cpu").in_channels == 63
    with pytest.raises(NotImplementedError):
        build_model("UNet-x", in_channels=5)
    assert model_family("LSTM-64K5.32K3.16K3-E33OMA-8C-BCB-x") == "LSTM"


def test_train_config_round_trip_with_jax(tmp_path):
    port = TrainConfig(model="LSTM-rt", levels=2, compute_dtype="bfloat16",
                       scheduler_config=(5, 0.5), snapshot_dir=str(tmp_path / "p"))
    assert port.in_channels == 8  # 3 * levels + 2, as the JAX config derives
    back = JTrainConfig.load(port.dump())
    for k in ("model", "in_channels", "compute_dtype", "scheduler_config", "levels",
              "hidden_channels", "input_size", "betas"):
        assert getattr(back, k) == getattr(port, k)
    assert TrainConfig.load(port.dump()) == port


@pytest.mark.parametrize("epoch", [0, 9, 10, 25])
def test_step_lr_matches_jax(epoch):
    assert step_lr(1e-3, 10.0, 0.9, epoch) == j_step_lr(1e-3, 10.0, 0.9, epoch)


def test_r2_matches_jax():
    rng = np.random.default_rng(3)
    y, p = rng.standard_normal((2, 5, 7)), rng.standard_normal((2, 5, 7))
    y, p = y.astype(np.float32), (0.6 * y + 0.4 * p).astype(np.float32)
    np.testing.assert_allclose(r2(torch.from_numpy(y), torch.from_numpy(p)).item(),
                               float(j_r2(y, p)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(T=40, H=12, W=20, seed=3),
    dict(T=30, H=10, W=16, nlev=3, seed=4),
    dict(T=25, H=8, W=12, species=("bcb", "clay"), n_static=2, seed=5),
])
def test_synthetic_fixture_byte_equal(kw):
    want, got = j_synthetic(**kw), synthetic_e33oma_90d(**kw)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes()


@pytest.mark.parametrize("period", ["train", "val", "test"])
def test_sequence_dataset_matches_jax(fixture, period):
    """Split, statistics, windows, forcing stream, static channels and the
    host-preprocessed sample equal the JAX package's."""
    data, _ = fixture
    kw = dict(period=period, sequence_length=SEQ, in_channels=7, padding=(20, 28))
    jds = jdata.SequenceDataset(data, host_preprocessed=True, **kw)
    tds = tdata.SequenceDataset(data, host_preprocessed=True, **kw)
    assert len(tds) == len(jds)
    for a, b in zip((tds.normalizer.x_mean, tds.normalizer.x_std),
                    (jds.normalizer.x_mean, jds.normalizer.x_std)):
        np.testing.assert_array_equal(a, b)
    assert (tds.normalizer.y_mean, tds.normalizer.y_std) == (
        jds.normalizer.y_mean, jds.normalizer.y_std)
    for a, b in zip(tds.forcing_stream(), jds.forcing_stream()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.static, jds.static)
    for i in (0, len(tds) - 1):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
        for a, b in zip(tds.raw_item(i), jds.raw_item(i)):
            np.testing.assert_array_equal(a, b)
    x = tds.raw_item(0)[0]
    np.testing.assert_array_equal(tds.with_static(x), jds.with_static(x))


def test_masked_log10_and_splits_match_jax():
    x = np.array([[-1.0, 0.0, 1e-3, 10.0]], np.float32)
    np.testing.assert_array_equal(tdata.masked_log10(x), jdata.masked_log10(x))
    for n in (10, 4319, 7):
        assert tdata.reference_splits(n) == jdata.reference_splits(n)
