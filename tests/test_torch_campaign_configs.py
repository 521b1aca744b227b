"""The port's campaign scripts of configs #1-#4 (scripts/torch_run_northstar_year.py,
torch_run_train_year.py, torch_run_seq2seq_protocol.py,
torch_run_year_rollout.py, torch_run_results_r02.py) and the canonical
launcher (scripts/torch_launch_canonical.sh), on the CPU (``--device cpu``;
gloo for ``--dp 2``) at a size a one-thread CPU takes: a 16 x 24 grid padded
to 20 x 28, hidden (8, 4), kernels (5, 3), windows of 4, one epoch.  The
sizes are the scripts' module constants, set here; their defaults stay the
JAX scripts'.

Each script writes its JSON with the JAX script's keys, every number in it
finite.  The north-star year's loop and the year rollout's per-block R^2
are held against the same loops written with the JAX package's
``make_rollout_fn`` (XLA cell) on the same weights (bridged by
``params_from_jax`` / ``params_to_jax``) in f32, to 1e-5 relative: the
two differ only in the order of f32 sums.  ``--dp 2`` on gloo gives the
first epoch's loss of ``--dp 1`` to 1e-6 relative in f32 (the all-reduce
averages two half-batch means in another order).  The launcher is parsed,
not run: every flag it passes is one the port's ``train/config.parse_args``
accepts, and they are the JAX launcher's flags with the same values."""

import json
import math
import os
import re
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.data import dataset as jdata  # noqa: E402
from nasa_niswan_tpu.data.synthetic import synthetic_e33oma_90d as jax_synthetic  # noqa: E402
from nasa_niswan_tpu.evalx import metrics as jmetrics  # noqa: E402
from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.rollout import autoregressive as jro  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402
from nasa_niswan_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from nasa_niswan_tpu_torch.train.config import parse_args  # noqa: E402

from test_torch_campaign_scripts import SCRIPTS, SMALL, _script  # noqa: E402
REL = 1e-5  # f32, the two packages' sums in other orders


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _finite(obj) -> bool:
    """Every number in a JSON-like object is finite."""
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def _written(path, result, keys):
    with open(path) as f:
        assert json.load(f) == result
    missing = [k for k in keys if k not in result]
    assert not missing, missing
    assert _finite(result), result


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------- north star

NS_MONTH, NS_STEPS, NS_BLOCK, NS_CHUNK = 8, 24, 8, 4


def test_northstar_year_writes_the_jax_keys(tmp_path):
    mod = _script("torch_run_northstar_year", MONTH=NS_MONTH, **SMALL)
    result = mod.main(["--device", "cpu", "--steps", str(NS_STEPS), "--block",
                       str(NS_BLOCK), "--chunk", str(NS_CHUNK), "--out", str(tmp_path)])
    _written(tmp_path / "results_northstar_year.json", result,
             ("config", "steps", "serving_wall_s", "model_days_per_min", "monthly_h1_rms"))
    assert result["steps"] == NS_STEPS
    assert len(result["monthly_h1_rms"]) == NS_STEPS // NS_MONTH
    assert all(h > 0 for h in result["monthly_h1_rms"])
    # on the CPU the cell is the plain version: no kernel launch is counted
    assert result["b1_plain_launches"] == 0 and result["chunk_copy_in_ms"] is None


@pytest.mark.parametrize("flags", [["--block", "10", "--chunk", "4"],
                                   ["--steps", "10", "--block", "8", "--chunk", "4"]],
                         ids=["ragged-block", "ragged-steps"])
def test_northstar_year_refuses_a_ragged_chunk(flags, tmp_path):
    """The block is cycled in whole chunks: a block or a year that is not a
    multiple of the chunk is refused, as in the JAX script."""
    mod = _script("torch_run_northstar_year", **SMALL)
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", "--out", str(tmp_path), *flags])


def test_northstar_loop_matches_jax():
    """The year loop on weights drawn by JAX, in f32, against the same loop
    through the JAX package's rollout: the monthly h1 RMS and the last
    chunk's predictions to 1e-5 relative.  The block, drawn and uploaded a
    few frames at a time, equals the JAX script's one-shot draw."""
    mod = _script("torch_run_northstar_year", MONTH=NS_MONTH, DRAW_FRAMES=3, **SMALL)
    C, grid, padded = mod.C, mod.GRID, mod.PADDED
    block = mod.forcing_block(NS_BLOCK, "cpu")
    want = np.random.default_rng(0).standard_normal((1, NS_BLOCK, C, *grid)).astype(np.float32)
    np.testing.assert_array_equal(block.numpy(), want)

    layers = dict(hidden_channels=mod.HIDDEN, kernel_sizes=mod.KERNELS)
    jcfg = jm.ConvLSTMConfig(in_channels=C, compute_dtype="float32", cell_impl="xla",
                             **layers)
    tree = jax.tree.map(np.asarray, jm.convlstm_init(jax.random.PRNGKey(0), jcfg))
    stats = (np.zeros(C, np.float32), np.ones(C, np.float32), 0.0, 1.0)
    cfg = ConvLSTMConfig(in_channels=C, compute_dtype="float32", **layers)
    rollout = make_rollout_fn(cfg, Normalizer(*stats), padded_shape=padded, grid_shape=grid)
    got = mod.year_loop(rollout, bridge.params_from_jax(tree), block, NS_STEPS, NS_CHUNK)

    jroll = jro.make_rollout_fn(jcfg, jdata.Normalizer(*stats), padded_shape=padded,
                                grid_shape=grid, cell_impl="xla")
    jblock, state, rms, done = jnp.asarray(want), None, [], 0
    while done < NS_STEPS:
        s = done % NS_BLOCK
        p, state = jroll(tree, jblock[:, s:s + NS_CHUNK], state)
        done += NS_CHUNK
        if done % NS_MONTH < NS_CHUNK:
            rms.append(float(jnp.sqrt(jnp.mean(jnp.square(state[0][0])))))
    assert got["steps"] == done and len(got["monthly_h1_rms"]) == len(rms) == 3
    assert _rel(got["monthly_h1_rms"], rms) <= REL, (got["monthly_h1_rms"], rms)
    assert _rel(got["preds"], p) <= REL


# ---------------------------------------------------------------- train year

TY = ["--device", "cpu", "--steps", "240", "--epochs", "1", "--seq-len", "4", "--stride",
      "4", "--grid", "16", "24", "--eval-windows", "16", "--ckpt-every", "1"]
TY_KEYS = ("what", "backend", "devices", "dp", "fixture_steps", "stride", "epochs",
           "optimizer_steps", "window_days_consumed", "years_equivalent", "campaign_wall_s",
           "steady_days_per_min", "steady_days_per_min_median", "final_train_loss",
           "final_val_r2", "epochs_log")


@pytest.fixture(scope="module")
def train_year(tmp_path_factory):
    """The campaign in f32 on one device and on two gloo ranks: the two
    results and the first one's directory."""
    mod = _script("torch_run_train_year", HIDDEN=(8, 4), KERNELS=(5, 3), DTYPE="float32")
    out = {}
    for dp in (1, 2):
        d = tmp_path_factory.mktemp(f"train_year_dp{dp}")
        out[dp] = mod.main([*TY, "--dp", str(dp), "--snapshot-dir", str(d / "snap"),
                            "--out", str(d / "results_train_year.json")])
        out[f"dir{dp}"] = d
    return out


def test_train_year_writes_the_jax_keys(train_year):
    one, d = train_year[1], train_year["dir1"]
    _written(d / "results_train_year.json", one, TY_KEYS)
    assert one["dp"] == 1 and one["backend"] == "cpu" and one["epochs"] == 1
    assert len(one["epochs_log"]) == 1 and one["optimizer_steps"] > 0
    assert one["window_days_consumed"] == one["optimizer_steps"] * 8 * 4 / 48
    assert os.path.isfile(d / "snap" / "epoch-001" / "checkpoint.npz")


def test_train_year_dp2_matches_dp1(train_year):
    one, two = train_year[1], train_year[2]
    assert two["dp"] == 2 and two["optimizer_steps"] == one["optimizer_steps"]
    a, b = one["epochs_log"][0]["train_loss"], two["epochs_log"][0]["train_loss"]
    assert abs(b - a) <= 1e-6 * abs(a), (a, b)
    assert abs(two["final_val_r2"] - one["final_val_r2"]) <= 1e-5, (two, one)


# ------------------------------------------------------------ seq2seq protocol

def test_seq2seq_protocol_writes_the_jax_keys(tmp_path):
    mod = _script("torch_run_seq2seq_protocol", SEQ=4, **SMALL)
    result = mod.main(["--device", "cpu", "--steps", "120", "--epochs", "1", "--out",
                       str(tmp_path)])
    _written(tmp_path / "results_seq2seq.json", result,
             ("config", "epochs", "final_teacher_prob_scheduled", "scheduled",
              "teacher_only"))
    for label in ("scheduled", "teacher_only"):
        rec = result[label]
        assert set(rec) == {"wall_s", "val_r2_curve", "test_closed_loop_r2"}
        assert len(rec["val_r2_curve"]) == 1
        assert os.path.isdir(tmp_path / label / "epoch-001")
    assert 0 < result["final_teacher_prob_scheduled"] < 1


# --------------------------------------------------------------- year rollout

YR_BLOCK, YR_STEPS, YR_CHUNK = 16, 120, 16


@pytest.fixture(scope="module")
def year_rollout(tmp_path_factory):
    out = tmp_path_factory.mktemp("year_rollout")
    mod = _script("torch_run_year_rollout", SEQ=4, BLOCK=YR_BLOCK, DTYPE="float32", **SMALL)
    result = mod.main(["--device", "cpu", "--steps", str(YR_STEPS), "--train-days", "1",
                       "--epochs", "1", "--chunk", str(YR_CHUNK), "--out", str(out)])
    return mod, out, result


def test_year_rollout_writes_the_jax_keys(year_rollout):
    mod, out, result = year_rollout
    _written(out / "results_year.json", result,
             ("config", "train_days", "epochs", "train_wall_s", "final_val_r2",
              "rollout_steps", "rollout_wall_s", "rollout_days_per_min",
              "temporal_r2_overall_mean", "temporal_r2_last30d_mean",
              "temporal_r2_by_30d_block"))
    n = YR_STEPS - 48
    assert result["rollout_steps"] == n
    assert len(result["temporal_r2_by_30d_block"]) == -(-n // YR_BLOCK)
    assert os.path.isfile(out / "run" / "epoch-001" / "checkpoint.npz")


def test_year_rollout_blocks_match_jax(year_rollout):
    """The trained weights (read back from the run's checkpoint) served by
    the JAX package's rollout over the same chunks: the per-block R^2 to
    1e-5 relative (f32)."""
    mod, out, result = year_rollout
    layers = dict(hidden_channels=mod.HIDDEN, kernel_sizes=mod.KERNELS)
    tmpl = convlstm_init(torch.Generator().manual_seed(0),
                         ConvLSTMConfig(in_channels=8, **layers))
    params, _, _ = load_checkpoint(str(out / "run" / "epoch-001"), tmpl)
    tree = bridge.params_to_jax(params)

    data = jax_synthetic(T=YR_STEPS, seed=7, H=mod.GRID[0], W=mod.GRID[1])
    n_train = 48
    head = {k: (v if k == "static" else v[:n_train]) for k, v in data.items()}
    norm = jdata.SequenceDataset(head, period="train", sequence_length=mod.SEQ,
                                 species="bcb", in_channels=8).normalizer
    jcfg = jm.ConvLSTMConfig(in_channels=8, compute_dtype="float32", cell_impl="xla",
                             **layers)
    jroll = jro.make_rollout_fn(jcfg, norm, padded_shape=mod.PADDED, grid_shape=mod.GRID,
                                static=data["static"][:3], cell_impl="xla")
    forcings = np.stack([data[k] for k in ("u", "v", "omega", "prec", "bcb_src")],
                        axis=1).astype(np.float32)
    preds, state = [], None
    for s in range(n_train, YR_STEPS, YR_CHUNK):
        p, state = jroll(tree, forcings[None, s:s + YR_CHUNK], state)
        preds.append(np.asarray(p[0]))
    preds = np.concatenate(preds)
    r2_t = np.asarray(jmetrics.r2_temporal(data["bcb_conc"][n_train:], preds))
    want = [float(np.nanmean(r2_t[i:i + YR_BLOCK])) for i in range(0, len(r2_t), YR_BLOCK)]
    got = [b["r2_mean"] for b in result["temporal_r2_by_30d_block"]]
    assert len(got) == len(want)
    assert _rel(got, want) <= REL, (got, want)


# -------------------------------------------------------------------- r02

def test_results_r02_writes_the_jax_keys(tmp_path):
    mod = _script("torch_run_results_r02", SEQ=4, DRIFT_CHUNK=8, **SMALL)
    report = mod.main(["--device", "cpu", "--steps", "120", "--epochs", "1", "--epochs-b",
                       "1", "--out", str(tmp_path)])
    _written(tmp_path / "results_r02.json", report, ("A", "B"))
    a, b = report["A"], report["B"]
    for key in ("config", "epochs", "train_wall_s", "final_train_r2", "final_val_r2",
                "windowed", "rollout", "bf16_drift_vs_f32"):
        assert key in a, key
    for part in ("windowed", "rollout", "rollout_hoisted"):
        assert set(a[part]) >= {"temporal_r2", "global_r2", "pearson_r", "wall_s"}
    assert set(a["bf16_drift_vs_f32"]) == {"nrmse_first100_mean", "nrmse_last100_mean",
                                           "nrmse_max"}
    # the hoisted rollout is the same function, its sums in another order
    assert a["rollout_hoisted"]["max_abs_diff_over_std"] <= 5e-2
    for label in ("scheduled", "teacher_only"):
        assert set(b[label]) == {"wall_s", "teacher_prob_final", "closed_loop_val_r2"}
    assert os.path.isdir(tmp_path / "runA" / "epoch-001")


@pytest.mark.parametrize("skip, kept", [("--skip-a", "B"), ("--skip-b", "A")])
def test_results_r02_skips_a_part(skip, kept, tmp_path):
    mod = _script("torch_run_results_r02", SEQ=4, DRIFT_CHUNK=8, **SMALL)
    report = mod.main(["--device", "cpu", "--steps", "120", "--epochs", "1", "--epochs-b",
                       "1", "--out", str(tmp_path), skip])
    assert list(report) == [kept] and _finite(report)


# ------------------------------------------------------------------ launcher

def _launcher_args(name: str):
    """(module, arguments) of the ``python -m`` line of scripts/<name>, the
    shell's variables replaced by fixed values and "$@" dropped."""
    with open(os.path.join(SCRIPTS, name)) as f:
        text = f.read()
    m = re.search(r"python -m (\S+) \\\n(.*?)\"\$@\"", text, re.S)
    assert m, f"no python -m line in {name}"
    body = m.group(2).replace("\\\n", " ")
    body = body.replace("${STAMP}", "20260101-0000").replace("${SNAP}", "snapshots/run")
    return m.group(1), shlex.split(body)


def test_launch_canonical_passes_only_flags_the_port_accepts():
    module, argv = _launcher_args("torch_launch_canonical.sh")
    assert module == "nasa_niswan_tpu_torch.train"
    cfg = parse_args(argv)  # argparse exits on a flag it does not know
    assert cfg.in_channels == 8 and cfg.hidden_channels == (64, 32, 16)
    assert cfg.kernel_size == (5, 3, 3) and cfg.num_layers == 3
    assert cfg.sequence_length == 48 and cfg.num_epochs == 30 and cfg.batch_size == 8
    assert cfg.input_size == (100, 154) and cfg.scheduler_config == (10, 0.9)
    assert cfg.betas == (0.5, 0.999) and cfg.learning_rate == 1e-3
    assert cfg.compute_dtype == "bfloat16" and cfg.device == "cuda"
    assert cfg.snapshot_dir == "snapshots/run"


def test_launch_canonical_has_the_jax_launchers_flags():
    module, argv = _launcher_args("torch_launch_canonical.sh")
    jax_module, jax_argv = _launcher_args("launch_canonical.sh")
    assert jax_module == "nasa_niswan_tpu.train"
    assert argv == jax_argv
