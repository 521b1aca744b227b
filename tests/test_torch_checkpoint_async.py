"""The port's asynchronous checkpoint backend (train/checkpoint_async.py,
``--checkpoint-backend orbax``) and preemption recovery, modelled on
tests/test_preemption.py: the training CLI (``python -m
nasa_niswan_tpu_torch.train --device cpu``) is SIGKILLed right after its
second epoch checkpoint and relaunched with ``--auto-resume``, on both
backends; its final parameters must equal an uninterrupted control's bit
for bit (the shuffle order is seeded per epoch, Adam's state is restored
exactly, and the CPU kernels repeat).  Then ``AsyncCheckpointer`` alone: a
round trip with model state and Adam's moments, an empty directory, a save
that returns before its files are committed and keeps the values it was
given, ``max_to_keep``, a torn write left by a kill, a failed write, and a
directory written by the JAX package's orbax backend, which is refused."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cli_utils import cpu_env  # noqa: E402

from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.train import checkpoint_async  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint_async import AsyncCheckpointer  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig  # noqa: E402
from nasa_niswan_tpu_torch.train.loop import make_optimizer  # noqa: E402

EPOCHS = 4  # the kill lands in epoch 3; the resumed run covers 3..4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cmd(snap, backend):
    return [
        sys.executable, "-m", "nasa_niswan_tpu_torch.train", "--device", "cpu",
        "--model", "LSTM-preempt", "--hidden-channels", "4", "--kernel-size", "3",
        "--num-layers", "1", "--sequence-length", "3", "--num-epochs", str(EPOCHS),
        "--batch-size", "4", "--input-size", "20", "28", "--synthetic-steps", "300",
        "--synthetic-grid", "16", "24", "--snapshot-dir", snap, "--checkpoint-every", "1",
        "--checkpoint-backend", backend, "--auto-resume",
    ]


def _env():
    env = dict(cpu_env(), PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def _run_full(snap, backend):
    out = subprocess.run(_cmd(snap, backend), capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _run_and_kill_after_checkpoints(snap, backend, n_checkpoints):
    """Launch the CLI and SIGKILL it right after the n-th epoch checkpoint
    line ("Learning Rate:", printed when the save has been made or, for the
    async backend, queued), i.e. in epoch n + 1."""
    proc = subprocess.Popen(_cmd(snap, backend), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=_env(), cwd=REPO)
    seen = 0
    try:
        for line in proc.stdout:
            if line.startswith("Learning Rate:"):
                seen += 1
                if seen >= n_checkpoints:
                    proc.kill()
                    break
    finally:
        proc.wait(timeout=60)
        proc.stdout.close()
    assert proc.returncode != 0, "the kill must interrupt the run"
    assert seen >= n_checkpoints, "the run died before the kill point"


def _params(ckpt_dir):
    with np.load(os.path.join(ckpt_dir, "checkpoint.npz")) as f:
        return {k: f[k].copy() for k in f.files if k.startswith("p")}


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """One uninterrupted run, the oracle of both backends (a backend changes
    how checkpoints are written, never the trajectory)."""
    snap = str(tmp_path_factory.mktemp("preempt") / "control")
    _run_full(snap, "npz")
    return snap


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_kill_and_resume_is_bit_exact(tmp_path, control, backend):
    victim = str(tmp_path / "victim")
    _run_and_kill_after_checkpoints(victim, backend, n_checkpoints=2)
    final = (os.path.join(victim, "orbax", f"epoch-{EPOCHS:03d}") if backend == "orbax"
             else os.path.join(victim, f"epoch-{EPOCHS:03d}"))
    assert not os.path.isdir(final)
    out = _run_full(victim, backend)
    # it restored (the async backend from its newest committed save: the
    # epoch-2 save may not have been committed before the kill)
    assert "Number of Epochs:" in out and "Epoch: 1," not in out
    if backend == "npz":
        assert "Number of Epochs: 2" in out and "Epoch: 3," in out
    else:
        assert not os.path.isdir(os.path.join(victim, f"epoch-{EPOCHS:03d}"))
        assert AsyncCheckpointer(os.path.join(victim, "orbax")).committed()[-1] == \
            f"epoch-{EPOCHS:03d}"
    want, got = _params(os.path.join(control, f"epoch-{EPOCHS:03d}")), _params(final)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert os.path.isfile(os.path.join(victim, "logger.log"))


def _unet():
    bundle = build_model("UNet-ck", in_channels=5, unet_features=(4, 8, 16, 32))
    params, state = bundle.init(torch.Generator().manual_seed(0), "cpu")
    opt = make_optimizer(params, 1e-3, (0.5, 0.999))
    out, state = bundle.apply(params, state, torch.randn(2, 16, 16, 5), training=True)
    out.square().mean().backward()
    opt.step()
    return bundle, params, state, opt


def _template(bundle):
    return bundle.init(torch.Generator().manual_seed(1), "cpu")


def test_round_trip_with_model_state(tmp_path):
    bundle, params, state, opt = _unet()
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(3, params, opt, learning_rate=5e-4, model_state=state)
    ck.close()
    tmpl_p, tmpl_s = _template(bundle)
    p, o, s, meta = AsyncCheckpointer(str(tmp_path / "ck")).restore_latest(
        tmpl_p, state_template=tmpl_s)
    assert meta["epoch"] == 3 and meta["learning_rate"] == 5e-4 and o["step"] == 1
    for a, b in zip(param_leaves(p), param_leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(bridge.tree_leaves(s), bridge.tree_leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(o["exp_avg_sq"], param_leaves(params)):
        np.testing.assert_array_equal(a, opt.state[b]["exp_avg_sq"].numpy())


def test_empty_directory_restores_nothing(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "none"))
    assert ck.restore_latest(_template(_unet()[0])[0]) is None
    assert ck.committed() == []
    ck.close()


def test_save_returns_before_commit_with_the_values_it_was_given(tmp_path, monkeypatch):
    """The write waits on an event; save returns, nothing is committed yet,
    and a change to the parameters after save (the next Adam step) does not
    reach the checkpoint."""
    gate = threading.Event()
    write = checkpoint_async.write_checkpoint

    def gated(*args):
        assert gate.wait(timeout=60)
        return write(*args)

    monkeypatch.setattr(checkpoint_async, "write_checkpoint", gated)
    bundle, params, state, opt = _unet()
    before = [t.detach().clone() for t in param_leaves(params)]
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(1, params, opt, model_state=state)
    assert ck.committed() == []
    with torch.no_grad():
        for t in param_leaves(params):
            t.add_(1.0)
    gate.set()
    ck.wait()
    assert ck.committed() == ["epoch-001"]
    tmpl_p, _ = _template(bundle)
    p, _, _ = ck.restore_latest(tmpl_p)
    for a, b in zip(param_leaves(p), before):
        assert torch.equal(a, b)
    ck.close()


def test_max_to_keep_and_torn_writes(tmp_path):
    bundle, params, state, opt = _unet()
    root = tmp_path / "ck"
    torn = root / ".tmp-epoch-009"
    torn.mkdir(parents=True)
    (torn / "checkpoint.npz.tmp").write_bytes(b"torn")
    ck = AsyncCheckpointer(str(root), max_to_keep=2)
    assert ck.committed() == []  # a torn write is never a checkpoint
    for step in range(1, 5):
        ck.save(step, params, opt, model_state=state)
    ck.close()
    assert ck.committed() == ["epoch-003", "epoch-004"]
    assert not torn.exists()


def test_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint_async, "write_checkpoint", broken)
    _, params, _, opt = _unet()
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(1, params, opt)
    with pytest.raises(OSError, match="disk full"):
        ck.close()


def test_jax_orbax_directory_is_refused(tmp_path):
    """A directory of the JAX package's orbax backend is refused with a
    message, not misread."""
    import jax

    from nasa_niswan_tpu.models.registry import build_model as j_build_model
    from nasa_niswan_tpu.train.checkpoint_orbax import AsyncCheckpointer as JAsync

    jparams, _ = j_build_model("LSTM-o", in_channels=5, hidden_channels=(4,),
                               kernel_sizes=(3,)).init(jax.random.PRNGKey(0))
    jck = JAsync(str(tmp_path / "orbax"))
    jck.save(2, jparams)
    jck.close()
    with pytest.raises(ValueError, match="orbax step directories"):
        AsyncCheckpointer(str(tmp_path / "orbax"))


def test_config_carries_the_backend(tmp_path):
    """``checkpoint_backend`` reads from a configurations.json of either
    package and is checked."""
    from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig

    path = JTrainConfig(checkpoint_backend="orbax", snapshot_dir=str(tmp_path)).dump()
    assert TrainConfig.load(path).checkpoint_backend == "orbax"
    assert TrainConfig().checkpoint_backend == "npz"
    with open(TrainConfig(checkpoint_backend="orbax", snapshot_dir=str(tmp_path / "t")
                          ).dump()) as f:
        assert json.load(f)["checkpoint_backend"] == "orbax"
    with pytest.raises(ValueError, match="npz|orbax"):
        TrainConfig(checkpoint_backend="zarr")
