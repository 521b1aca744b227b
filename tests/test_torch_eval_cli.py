"""Snapshots written by the JAX trainer load in the port
(nasa_niswan_tpu_torch/evalx/snapshot.py), and the two evaluation CLIs give
the same report on them: the canonical (config #1) snapshot in the
windowed and rollout modes, and the seq2seq (config #3) snapshot's closed
loop.  The port runs on the CPU (``--device cpu``).

Tolerances: the predictions in test-results.npy at atol 2e-5, that of
tests/test_torch_rollout.py for the same computation (XLA's f32 convs
against the port's plain cell); the R^2 values computed from them at
rtol 1e-4."""

import json
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.evalx import __main__ as j_cli  # noqa: E402
from nasa_niswan_tpu.evalx.evaluate import load_test_results  # noqa: E402
from nasa_niswan_tpu.evalx.snapshot import load_snapshot as j_load  # noqa: E402
from nasa_niswan_tpu_torch.evalx import __main__ as t_cli  # noqa: E402
from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot as t_load  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import param_leaves  # noqa: E402

ATOL_PRED = 2e-5
RTOL_R2 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _copy(snap, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(snap, dst)
    return dst


@pytest.mark.parametrize("which", ["canonical_snap", "seq2seq_snap"])
def test_jax_snapshot_loads_in_the_port(request, which):
    snap = request.getfixturevalue(which)
    want = j_load(snap)
    got = t_load(snap, device="cpu")
    assert got.closed_loop == want.closed_loop == (which == "seq2seq_snap")
    assert got.padded_shape == want.padded_shape
    assert got.n_forcing == want.n_forcing
    assert got.meta["epoch"] == want.meta["epoch"]
    for t, j in zip(param_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    frames_t = got.dataset[0][0]
    frames_j = want.dataset[0][0]
    np.testing.assert_array_equal(np.asarray(frames_t), np.asarray(frames_j))


def _run_both(snap, tmp_path, *extra):
    """Both CLIs on copies of one snapshot: (jax report, port report, jax
    results, port results)."""
    jdir, tdir = _copy(snap, tmp_path, "j"), _copy(snap, tmp_path, "t")
    jrep = j_cli.main(["--run-dir", jdir, *extra])
    trep = t_cli.main(["--run-dir", tdir, "--device", "cpu", *extra])
    jres = load_test_results(os.path.join(jdir, "test-results.npy"))
    tres = load_test_results(os.path.join(tdir, "test-results.npy"))
    with open(os.path.join(tdir, "evaluation.json")) as f:
        assert json.load(f)["global_r2"] == trep["global_r2"]
    return jrep, trep, jres, tres


def _same_report(jrep, trep, jres, tres):
    np.testing.assert_array_equal(tres[0], jres[0])
    np.testing.assert_allclose(tres[1], jres[1], atol=ATOL_PRED)
    for key in ("global_r2", "pearson_r"):
        np.testing.assert_allclose(trep[key], jrep[key], rtol=RTOL_R2)
    for k in ("mean", "median", "max", "min"):
        np.testing.assert_allclose(trep["temporal_r2_summary"][k],
                                   jrep["temporal_r2_summary"][k], rtol=RTOL_R2)


@pytest.mark.parametrize("mode", ["windowed", "rollout"])
def test_eval_cli_reports_match_jax(canonical_snap, tmp_path, mode, capsys):
    _same_report(*_run_both(canonical_snap, tmp_path, "--mode", mode))
    out = capsys.readouterr().out
    assert out.count("temporal R2 mean/median/max:") == 2
    assert out.count("global R2:") == 2


def test_eval_cli_closed_loop_matches_jax(seq2seq_snap, tmp_path, capsys):
    _same_report(*_run_both(seq2seq_snap, tmp_path))
    assert capsys.readouterr().out.count("running closed-loop feedback evaluation") == 2


def test_eval_cli_hidden_and_oat(canonical_snap, seq2seq_snap, tmp_path):
    """--export-hidden and --oat write what the JAX CLI writes, and the
    closed loop refuses them."""
    tdir = _copy(canonical_snap, tmp_path, "t")
    t_cli.main(["--run-dir", tdir, "--device", "cpu", "--export-hidden", "--oat",
                "--batch-size", "4"])
    hss = np.load(os.path.join(tdir, "HSs.npy"))
    assert hss.ndim == 4 and np.isfinite(hss).all()
    with np.load(os.path.join(tdir, "oat_sensitivity.npz")) as z:
        assert sorted(z.files) == sorted(("u", "v", "w", "prec", "src"))
    with pytest.raises(SystemExit):
        t_cli.main(["--run-dir", _copy(seq2seq_snap, tmp_path, "s"), "--device", "cpu",
                    "--oat"])


def test_eval_cli_defaults_to_the_card(canonical_snap, tmp_path):
    """Without --device the CLI asks for the card, and raises here where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--run-dir", _copy(canonical_snap, tmp_path, "c")])
