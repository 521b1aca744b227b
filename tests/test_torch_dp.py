"""The port's data-parallel training (nasa_niswan_tpu_torch/parallel/dp.py,
``fit(mesh=)``, ``fit_seq2seq(dp_devices=)`` and the training CLI's
``--dp-devices``) on two gloo ranks, against the single-device step on the
same global batches and the JAX package's ``make_dp_train_step_shardmap``
on a (2,) mesh of its CPU devices.

Tolerances: the dp = 2 step against the one-rank step, loss, R^2 and every
parameter after 2 Adam steps within 1e-6 relative (the global mean taken
as a mean of two means: f32 sums in another order); against JAX, loss and
R^2 within 1e-5 (XLA's convs against the port's plain cell).  R^2 is held
through its residual share 1 - R^2: on random weights R^2 is near 0, where
a relative bound on R^2 itself measures nothing."""

import json
import os

import numpy as np
import pytest

import jax
import optax

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models.registry import build_model as j_build_model  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu.parallel.dp import make_dp_train_step_shardmap  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Seq2SeqDataset, SequenceDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.parallel import launch  # noqa: E402
from nasa_niswan_tpu_torch.rollout.seq2seq import fit_seq2seq  # noqa: E402
from nasa_niswan_tpu_torch.train import __main__ as train_cli  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import load_checkpoint, param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import fit, make_optimizer, make_train_step  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402

GRID, PADDED = (16, 24), (20, 28)
GEO = dict(padded_shape=PADDED, grid_shape=GRID)
MODEL = dict(in_channels=5, hidden_channels=(4, 4), kernel_sizes=(5, 3))
LR, BETAS = 1e-3, (0.5, 0.999)
BS, SEQ = 4, 4
S2S = dict(in_channels=6, hidden_channels=(4, 4), kernel_sizes=(5, 3))
S2S_FIT = dict(padded_shape=PADDED, grid_shape=GRID, num_epochs=1, batch_size=2,
               learning_rate=LR, betas=BETAS, seed=5)
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(in_channels, seed):
    bundle = j_build_model("LSTM-dp", in_channels=in_channels, hidden_channels=(4, 4),
                           kernel_sizes=(5, 3), cell_impl="xla")
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(seed))[0])


def _fit_cfg(snapshot_dir):
    return dict(model="LSTM-dp", in_channels=5, hidden_channels=(4, 4), kernel_size=(5, 3),
                num_layers=2, batch_size=BS, sequence_length=SEQ, num_epochs=2,
                input_size=PADDED, checkpoint_every=0, snapshot_dir=snapshot_dir)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    data = dict(T=60, H=GRID[0], W=GRID[1], seed=7)
    ds = SequenceDataset(synthetic_e33oma_90d(**data), period="train",
                         sequence_length=SEQ, in_channels=5)
    batches = []
    for s in range(2):
        idx = np.random.default_rng(s).permutation(len(ds))[:BS]
        xs, ys = zip(*(ds[int(i)] for i in idx))
        batches.append((np.stack(xs), np.stack(ys)))
    return dict(data=data, seq=dict(sequence_length=SEQ, in_channels=5), model=MODEL,
                params=_tree(5, 0), opt=(LR, BETAS), geo=GEO, batches=batches,
                s2s_cfg=S2S, s2s_params=_tree(6, 1), s2s_fit=S2S_FIT,
                fit=_fit_cfg(str(tmp_path_factory.mktemp("dpfit"))))


@pytest.fixture(scope="module")
def dp_run(case):
    return launch.spawn(ranks.dp_world, 2, "cpu", case, timeout=300)


def _one_rank(case, remat):
    ds = SequenceDataset(synthetic_e33oma_90d(**case["data"]), period="train",
                         **case["seq"])
    params = bridge.params_from_jax(case["params"])
    for t in param_leaves(params):
        t.requires_grad_(True)
    opt = make_optimizer(params, LR, BETAS)
    step = make_train_step(build_model("LSTM-dp", remat=remat, **MODEL), ds.normalizer,
                           opt, **GEO)
    metrics = []
    for x, y in case["batches"]:
        _, m = step(params, None, x, y)
        metrics.append((m["loss"].item(), m["r2"].item()))
    return np.array(metrics), [t.detach().numpy() for t in param_leaves(params)]


def _metrics_close(got, want, rtol):
    """(loss, R^2) rows: the loss, and R^2 through its residual share
    1 - R^2 (R^2 itself is near 0 on random weights)."""
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol)
    np.testing.assert_allclose(1.0 - got[:, 1], 1.0 - want[:, 1], rtol=rtol)


@pytest.mark.parametrize("route", ["remat", "per-cell"])
def test_dp_step_matches_one_rank(case, dp_run, route):
    """dp = 2 against the single-device step on the same global batches:
    loss, R^2 and every parameter after 2 steps; both ranks hold the same
    parameters."""
    want_m, want_p = _one_rank(case, route == "remat")
    got = dp_run[0][route]
    _metrics_close(got["metrics"], want_m, RTOL)
    for a, b, c in zip(got["params"], dp_run[1][route]["params"], want_p):
        np.testing.assert_array_equal(a, b)
        assert np.max(np.abs(a - c)) <= RTOL * np.max(np.abs(c))


def test_dp_step_matches_jax_shardmap(case, dp_run):
    """Against the JAX package's manual DP step on a (2,) mesh (XLA cell,
    optax Adam): loss and R^2 of both steps."""
    ds = SequenceDataset(synthetic_e33oma_90d(**case["data"]), period="train",
                         **case["seq"])
    from nasa_niswan_tpu.data import dataset as jdata

    norm = jdata.Normalizer(*(getattr(ds.normalizer, f)
                              for f in ("x_mean", "x_std", "y_mean", "y_std")))
    bundle = j_build_model("LSTM-dp", cell_impl="xla", **MODEL)
    opt = optax.adam(LR, b1=BETAS[0], b2=BETAS[1], eps=1e-8)
    mesh = jmesh.make_mesh(dp=2, devices=jax.devices()[:2])
    step = make_dp_train_step_shardmap(bundle, norm, opt, mesh, **GEO)
    params, state = case["params"], None
    opt_state = opt.init(params)
    want = []
    for x, y in case["batches"]:
        params, state, opt_state, m = step(params, state, opt_state, x, y,
                                           jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["r2"])))
    _metrics_close(dp_run[0]["remat"]["metrics"], np.array(want), 1e-5)


def test_fit_seq2seq_dp_matches_one_device(case, dp_run):
    """One epoch of ``fit_seq2seq(dp_devices=2)``: the losses and R^2 of
    the single-device epoch (the draws are global, so the trajectory is the
    single-device one)."""
    s2s = Seq2SeqDataset(synthetic_e33oma_90d(**case["data"]), period="train",
                         sequence_length=SEQ)
    params = bridge.params_from_jax(case["s2s_params"])
    for t in param_leaves(params):
        t.requires_grad_(True)
    _, _, want = fit_seq2seq(ConvLSTMConfig(**S2S), params, s2s, verbose=False, **S2S_FIT)
    got = dp_run[0]["seq2seq"]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=RTOL)
    np.testing.assert_allclose(1.0 - got[0]["r2"], 1.0 - want[0]["r2"], rtol=RTOL)
    assert got[0]["teacher_prob"] == want[0]["teacher_prob"]


def test_streamed_fit_over_a_mesh_matches_one_device(case, dp_run, tmp_path):
    """``fit(device_resident=False)`` over a (2,) mesh (each rank streams
    its share of every batch through ``async_batches(shard=)``, validation
    split over the ranks and gathered) logs what the single-device
    streamed ``fit`` logs, two epochs."""
    data = synthetic_e33oma_90d(**case["data"])
    ds, val = (SequenceDataset(data, period=p, **case["seq"]) for p in ("train", "val"))
    want = fit(build_model("LSTM-dp", **MODEL), ds, val,
               TrainConfig(**_fit_cfg(str(tmp_path))), device="cpu",
               device_resident=False, verbose=False)["logger"]
    got = dp_run[0]["streamed"]
    np.testing.assert_allclose(got["MSELoss"], want["MSELoss"], rtol=RTOL)
    for key in ("r2_score", "r2_score_val"):
        np.testing.assert_allclose(1.0 - np.array(got[key]), 1.0 - np.array(want[key]),
                                   rtol=RTOL)


CLI = ["--device", "cpu", "--model", "LSTM-dpcli", "--num-layers", "2",
       "--hidden-channels", "4", "4", "--kernel-size", "5", "3", "--batch-size", "4",
       "--sequence-length", "4", "--synthetic-steps", "60", "--synthetic-grid", "16", "24",
       "--input-size", "20", "28", "--num-epochs", "2", "--checkpoint-every", "2"]


def _cli(argv, snap):
    cfg = parse_args([*argv, "--snapshot-dir", snap])
    cfg.dump()
    return train_cli.main(cfg)


def test_train_cli_dp_devices_matches_one_device(tmp_path):
    """``--dp-devices 2`` (two CPU ranks) writes the snapshot of
    ``--dp-devices 1``: the logger and the epoch-2 checkpoint within the
    step's tolerance, and the config keeps ``dp_devices``."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _cli(CLI, one)
    out = _cli([*CLI, "--dp-devices", "2"], two)
    assert set(out["logger"]) == {"MSELoss", "r2_score", "r2_score_val"}
    with open(os.path.join(two, "configurations.json")) as f:
        assert json.load(f)["dp_devices"] == 2
    with open(os.path.join(one, "logger.npy"), "rb") as a, \
            open(os.path.join(two, "logger.npy"), "rb") as b:
        np.testing.assert_allclose(np.load(b), np.load(a), rtol=RTOL)  # loss
        for _ in range(2):  # train and val R^2, through 1 - R^2
            np.testing.assert_allclose(1.0 - np.load(b), 1.0 - np.load(a), rtol=RTOL)
    template = build_model("LSTM-dpcli", in_channels=5, hidden_channels=(4, 4),
                           kernel_sizes=(5, 3)).init(torch.Generator().manual_seed(0))[0]
    p1, _, _ = load_checkpoint(os.path.join(one, "epoch-002"), template, lr=LR)
    p2, _, _ = load_checkpoint(os.path.join(two, "epoch-002"), template, lr=LR)
    for a, b in zip(param_leaves(p2), param_leaves(p1)):
        a, b = a.detach().numpy(), b.detach().numpy()
        assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))
    for a, b in zip(param_leaves(out["params"]), param_leaves(p2)):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())


def test_train_cli_dp_devices_refuses_single_step_families(tmp_path, monkeypatch):
    """What stays refused of data-parallel training: a batch that does not
    split over the ranks, and the GAN step on the ranks of a process group
    (it has no data-parallel form in either package).  The UNet and
    pix2pix train under ``--dp-devices`` (tests/test_torch_dp_stateful.py)."""
    with pytest.raises(SystemExit, match="divisible"):
        train_cli.main(TrainConfig(model="UNet-dp", device="cpu", dp_devices=3,
                                   batch_size=8, snapshot_dir=str(tmp_path)))
    from nasa_niswan_tpu_torch.models.pix2pix import DiscriminatorConfig, GeneratorConfig
    from nasa_niswan_tpu_torch.train.gan import make_gan_train_step

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="GAN step has no data-parallel form"):
        make_gan_train_step(GeneratorConfig(), DiscriminatorConfig(), None, None)


def test_chip_smoke_two_rank_phase_on_gloo():
    """chip_smoke.py's two-rank phase (which the card's machine runs only
    with two cards) on two CPU ranks at a small size: the (1, 1, 2)
    sharded rollout equals the single-device rollout, the dp = 2 loss the
    one-rank loss."""
    import chip_smoke

    out = launch.spawn(chip_smoke.two_rank_phase, 2, "cpu", "cpu", dict(
        C=7, hidden=(8, 4), kernels=(5, 3), grid=GRID, padded=PADDED, steps=4, bs=4, T=4),
        timeout=300)
    assert out[0]["rollout_rms"] <= 1e-6 and out[0]["dp_loss_rel"] <= RTOL
    assert out[1] == {}
