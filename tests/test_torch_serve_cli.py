"""The port's serving CLI (``python -m nasa_niswan_tpu_torch.rollout``)
against the JAX package's on the snapshots the JAX trainer writes: the
open- and closed-loop routes give the same ``.nc`` predictions, a carry
persisted by either package resumes in the other, a split run equals one
run, an exported artifact serves what the live rollout serves, the
single-step snapshots serve on their own route, ``--sharded`` writes the
unsharded run on gloo ranks, an allocator refusal of the resident upload
serves the streamed run, and what the port does not serve raises.  Both CLIs run in-process; the port on
the CPU (``--device cpu``).

Tolerances: the two packages' predictions at atol 2e-5, that of
tests/test_torch_rollout.py for the same computation (XLA's f32 convs
against the port's plain cell); one package against itself, bit-equal."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.rollout.__main__ import main as j_serve  # noqa: E402
from nasa_niswan_tpu_torch.data.ncio import open_nc  # noqa: E402
from nasa_niswan_tpu_torch.evalx.evaluate import (  # noqa: E402
    predict_test_feedback,
    predict_test_set,
)
from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot  # noqa: E402
from nasa_niswan_tpu_torch.rollout.__main__ import main as t_serve  # noqa: E402
from nasa_niswan_tpu_torch.rollout.export import export_rollout  # noqa: E402

from test_torch_feedback import single_step_snapshot  # noqa: E402

ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _read(path, var="bcb_conc"):
    with open_nc(path) as f:
        return np.asarray(f[var]), np.asarray(f["time"])


def _snap(snap, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(snap, dst)
    return dst


def _port(*argv):
    return t_serve([*argv, "--device", "cpu"])


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
def test_serving_clis_write_equal_predictions(request, tmp_path, which):
    snap = _snap(request.getfixturevalue(which), tmp_path, "s")
    j_nc, t_nc = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    js = j_serve(["--run-dir", snap, "--out", j_nc, "--chunk", "4"])
    ts = _port("--run-dir", snap, "--out", t_nc, "--chunk", "4")
    for key in ("steps", "route", "cold_start", "suggested_spinup_steps"):
        assert ts[key] == js[key]
    (tp, tt), (jp, jt) = _read(t_nc), _read(j_nc)
    assert tp.shape == jp.shape and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    np.testing.assert_array_equal(tt, jt)
    assert os.path.isfile(os.path.join(snap, "serve_summary.json"))


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_carry_resumes_across_packages(request, tmp_path, which, first):
    """Steps 0-7 by one package with --state-out, steps 8-on by the other
    with --skip 8 --state-in: the halves stitch to one run of the second
    package."""
    snap = _snap(request.getfixturevalue(which), tmp_path, "s")
    serve_a, serve_b = (j_serve, _port) if first == "jax" else (_port, j_serve)
    carry = str(tmp_path / "carry.npz")

    def run(serve, out, *extra):
        argv = ["--run-dir", snap, "--out", str(tmp_path / out), "--chunk", "4", *extra]
        return serve(*argv) if serve is _port else serve(argv)

    run(serve_a, "p1.nc", "--steps", "8", "--state-out", carry)
    s2 = run(serve_b, "p2.nc", "--skip", "8", "--state-in", carry)
    assert not s2["cold_start"]
    run(serve_b, "full.nc")
    (p1, _), (p2, t2), (full, _) = (_read(str(tmp_path / n))
                                    for n in ("p1.nc", "p2.nc", "full.nc"))
    np.testing.assert_allclose(np.concatenate([p1, p2]), full, atol=ATOL)
    np.testing.assert_allclose(t2[0], 8 * 0.5)


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
def test_split_run_equals_one_run(request, tmp_path, which):
    snap = _snap(request.getfixturevalue(which), tmp_path, "s")
    carry = str(tmp_path / "carry.npz")
    _port("--run-dir", snap, "--out", str(tmp_path / "full.nc"), "--chunk", "4")
    _port("--run-dir", snap, "--out", str(tmp_path / "p1.nc"), "--steps", "8",
          "--chunk", "4", "--state-out", carry)
    _port("--run-dir", snap, "--out", str(tmp_path / "p2.nc"), "--skip", "8",
          "--chunk", "4", "--state-in", carry)
    (p1, _), (p2, _), (full, _) = (_read(str(tmp_path / n))
                                   for n in ("p1.nc", "p2.nc", "full.nc"))
    np.testing.assert_array_equal(np.concatenate([p1, p2]), full)
    with np.load(carry) as z:
        assert ("prev_norm" in z.files) == (which == "seq2seq_snap")


def _export(snap, art):
    """Export the snapshot's rollout on the CPU, chunk 4; returns its size."""
    s = load_snapshot(snap, device="cpu")
    return export_rollout(
        s.bundle.config, s.dataset.normalizer, s.params, batch=1, chunk_steps=4,
        n_channels=s.n_forcing, grid_shape=tuple(s.dataset[0][1].shape[-2:]),
        padded_shape=s.padded_shape, static=s.static, path=art,
    )


def test_artifact_serves_the_live_rollout(canonical_snap, tmp_path):
    """A .pt2 exported on the CPU (chunk 4) serves the stream as the live
    rollout does, bit for bit, and a mismatched signature is refused."""
    snap = _snap(canonical_snap, tmp_path, "s")
    art = str(tmp_path / "r.pt2")
    size = _export(snap, art)
    assert size == os.path.getsize(art) > 0
    _port("--run-dir", snap, "--out", str(tmp_path / "live.nc"), "--chunk", "4")
    summary = _port("--run-dir", snap, "--out", str(tmp_path / "art.nc"), "--artifact", art)
    assert summary["steps"] == 12
    np.testing.assert_array_equal(_read(str(tmp_path / "art.nc"))[0],
                                  _read(str(tmp_path / "live.nc"))[0])
    with pytest.raises(SystemExit, match="divisible"):
        _port("--run-dir", snap, "--out", str(tmp_path / "x.nc"), "--artifact", art,
              "--steps", "6", "--state-out", str(tmp_path / "c.npz"))


def test_artifact_of_another_device_is_refused(canonical_snap, tmp_path, monkeypatch):
    """A CPU artifact asked to serve on ``--device cuda`` raises before any
    serving (the device is taken as resolved, so no card is needed) and
    writes nothing; the loader refuses it too."""
    from nasa_niswan_tpu_torch.rollout.export import load_rollout_info
    from nasa_niswan_tpu_torch.train import __main__ as train_main

    snap = _snap(canonical_snap, tmp_path, "s")
    art = str(tmp_path / "r.pt2")
    _export(snap, art)
    monkeypatch.setattr(train_main, "resolve_device", lambda name: torch.device(name))
    out = tmp_path / "o.nc"
    with pytest.raises(SystemExit, match="exported for cpu"):
        t_serve(["--run-dir", snap, "--out", str(out), "--artifact", art,
                 "--device", "cuda"])
    assert not out.exists()
    assert not os.path.exists(os.path.join(snap, "serve_summary.json"))
    with pytest.raises(ValueError, match="exported for cpu"):
        load_rollout_info(art, device="cuda")
    assert load_rollout_info(art, device="cpu")[0].device == torch.device("cpu")


@pytest.mark.parametrize("argv", [
    ["--sharded", "3", "1"],
    ["--chunk", "0"],
    ["--skip", "-1"],
    ["--steps", "5", "--chunk", "4", "--state-out", "c.npz"],
    ["--skip", "99"],
])
def test_serving_cli_refusals(canonical_snap, tmp_path, argv):
    snap = _snap(canonical_snap, tmp_path, "s")
    argv = [a if a != "c.npz" else str(tmp_path / a) for a in argv]
    with pytest.raises(SystemExit):
        _port("--run-dir", snap, "--out", str(tmp_path / "o.nc"), *argv)


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
def test_sharded_serving_writes_the_unsharded_run(request, tmp_path, which):
    """``--sharded 2 2`` (four gloo ranks, 10 x 14 tiles of the 20 x 28
    padded grid) writes the unsharded run's predictions and carry, at the
    sharded rollout's tolerance (1e-5 of the predictions' std); its carry
    resumes an unsharded run and the reverse."""
    snap = _snap(request.getfixturevalue(which), tmp_path, "s")
    one, four = str(tmp_path / "one.nc"), str(tmp_path / "four.nc")
    c1, c4 = str(tmp_path / "c1.npz"), str(tmp_path / "c4.npz")
    _port("--run-dir", snap, "--out", one, "--chunk", "4", "--steps", "8", "--state-out", c1)
    s4 = _port("--run-dir", snap, "--out", four, "--chunk", "4", "--steps", "8",
               "--state-out", c4, "--sharded", "2", "2")
    assert s4["sharded"] == [2, 2] and s4["steps"] == 8
    (p1, t1), (p4, t4) = _read(one), _read(four)
    assert p4.shape == p1.shape
    assert np.max(np.abs(p4 - p1)) <= 1e-5 * p1.std()
    np.testing.assert_array_equal(t4, t1)
    with np.load(c1) as a, np.load(c4) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.max(np.abs(b[k] - a[k])) <= 1e-5 * max(a[k].std(), 1e-30), k
    rest1, rest4 = str(tmp_path / "r1.nc"), str(tmp_path / "r4.nc")
    _port("--run-dir", snap, "--out", rest1, "--chunk", "4", "--skip", "8", "--state-in", c4)
    _port("--run-dir", snap, "--out", rest4, "--chunk", "4", "--skip", "8", "--state-in", c1,
          "--sharded", "1", "2")
    (r1, _), (r4, _) = _read(rest1), _read(rest4)
    assert np.max(np.abs(r4 - r1)) <= 1e-5 * r1.std()


def test_sharded_serving_refusals(tmp_path):
    """``--sharded`` on a grid that does not tile (the canonical 100-row
    padded grid over 3 rows of ranks), with ``--artifact``, or for a
    single-step snapshot is refused before any rank starts."""
    from nasa_niswan_tpu_torch.train.config import TrainConfig

    canon, unet = str(tmp_path / "canon"), str(tmp_path / "unet")
    TrainConfig(input_size=(100, 154)).dump(canon)
    TrainConfig(model="UNet-x", input_size=(100, 154)).dump(unet)
    for argv, msg in (
        (["--run-dir", canon, "--sharded", "3", "1"], "must tile evenly"),
        (["--run-dir", canon, "--sharded", "2", "1", "--artifact", "a.pt2"], "--artifact"),
        (["--run-dir", unet, "--sharded", "2", "2"], "LSTM-family"),
        (["--run-dir", canon, "--sharded", "2", "2", "--device", "cuda"], "4 CUDA devices"),
    ):
        with pytest.raises(SystemExit, match=msg):
            t_serve(argv if "--device" in argv else [*argv, "--device", "cpu"])


def _refuse(exc):
    def upload(frames, device):
        raise exc
    return upload


def test_resident_upload_refused_streams_from_host(monkeypatch, capsys):
    """The JAX CLI's ``test_serve_guard_messages``: an allocator refusal of
    the resident upload falls back to the host array, with JAX's message."""
    import nasa_niswan_tpu_torch.rollout.__main__ as cli

    frames = np.zeros((4, 2, 3, 3), np.float32)
    monkeypatch.setattr(cli, "_upload", _refuse(torch.OutOfMemoryError("simulated")))
    got = cli._device_resident(frames, 4.0, torch.device("cpu"))
    assert got is frames  # fell back to the host array
    assert ("serve: device-resident upload of 0.00 GB failed (OutOfMemoryError); "
            "streaming chunks from host instead (--resident-gb 0 silences this)"
            in capsys.readouterr().err)
    assert cli._device_resident(frames, 0.0, torch.device("cpu")) is frames
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
def test_refused_upload_serves_the_streamed_run(request, tmp_path, monkeypatch, capsys,
                                                which):
    """A run whose resident upload the allocator refuses writes the
    predictions of ``--resident-gb 0`` bit for bit; any other error of the
    upload raises."""
    import nasa_niswan_tpu_torch.rollout.__main__ as cli

    snap = _snap(request.getfixturevalue(which), tmp_path, "s")
    streamed, refused = str(tmp_path / "streamed.nc"), str(tmp_path / "refused.nc")
    _port("--run-dir", snap, "--out", streamed, "--chunk", "4", "--resident-gb", "0")
    capsys.readouterr()
    monkeypatch.setattr(cli, "_upload", _refuse(torch.OutOfMemoryError("simulated")))
    _port("--run-dir", snap, "--out", refused, "--chunk", "4", "--resident-gb", "4")
    assert "streaming chunks from host instead" in capsys.readouterr().err
    np.testing.assert_array_equal(_read(refused)[0], _read(streamed)[0])
    monkeypatch.setattr(cli, "_upload", _refuse(RuntimeError("not an allocator refusal")))
    with pytest.raises(RuntimeError, match="not an allocator refusal"):
        _port("--run-dir", snap, "--out", refused, "--chunk", "4", "--resident-gb", "4")


@pytest.mark.parametrize("model", ["UNet-clisnap", "PIX2PIX-clisnap"])
def test_single_step_snapshot_raises(tmp_path, model):
    """A single-step snapshot (UNet-6ch: its closed loop; PIX2PIX: its
    one-frame samples) serves its whole test split on the ``single_step``
    route, the predictions those of the evaluation path; the flags of the
    recurrent stream raise with the JAX CLI's messages."""
    snap = single_step_snapshot(str(tmp_path / "s"), model)
    out = str(tmp_path / "o.nc")
    summary = _port("--run-dir", snap, "--out", out, "--chunk", "5")
    loaded = load_snapshot(snap, device="cpu")
    predict = predict_test_feedback if loaded.feedback_single else predict_test_set
    want = predict(loaded.bundle, loaded.params, loaded.eval_state, loaded.dataset,
                   padded_shape=loaded.padded_shape)["PDs"]
    assert summary["route"] == "single_step" and summary["suggested_spinup_steps"] == 0
    assert summary["steps"] == len(loaded.dataset)
    np.testing.assert_array_equal(_read(out)[0], want)
    for argv, msg in ((["--state-out", str(tmp_path / "c.npz")], "LSTM-family"),
                      (["--skip", "1"], "full split"), (["--steps", "2"], "full split")):
        with pytest.raises(SystemExit, match=msg):
            _port("--run-dir", snap, "--out", out, *argv)


def test_closed_loop_state_in_needs_the_feedback_frame(canonical_snap, seq2seq_snap,
                                                       tmp_path):
    """An open-loop carry (no prev_norm) cannot resume a seq2seq episode."""
    carry = str(tmp_path / "open.npz")
    _port("--run-dir", _snap(canonical_snap, tmp_path, "a"), "--out",
          str(tmp_path / "a.nc"), "--steps", "4", "--chunk", "4", "--state-out", carry)
    with pytest.raises(SystemExit, match="prev_norm"):
        _port("--run-dir", _snap(seq2seq_snap, tmp_path, "b"), "--out",
              str(tmp_path / "b.nc"), "--state-in", carry)
