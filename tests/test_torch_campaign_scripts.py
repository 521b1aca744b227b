"""The port's config #5 scripts (scripts/torch_bench_sharded_rollout.py,
torch_run_multitracer_demo.py, torch_run_decadal_rollout.py) run end to
end on the CPU (``--device cpu``, gloo for the sharded runs) at a size a
one-thread CPU takes: a 16 x 24 grid padded to 20 x 28, hidden (8, 4),
kernels (5, 3), windows of 4, one epoch on a 60-step fixture.  The sizes
are the scripts' module constants, set here; their defaults stay the JAX
scripts'.

The decadal rollout sharded over (lat, lon) = (1, 2) against the same
rollout on one device: the same step count, and per year and species an
R^2 within the bound derived below.  The two differ only in the order of f32 sums:
tests/test_torch_parallel.py holds a sharded rollout's predictions within
1e-5 of the target's std of the single-device one's, far inside the bf16
cell tolerance CELL_TOL = 1e-3 held there.  A perturbation d of every
prediction by at most CELL_TOL of the target's std moves R^2 = 1 -
SS_res / SS_tot by at most 2 CELL_TOL sqrt(1 - R^2) + CELL_TOL^2: the
bound, per year and species."""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
SMALL = dict(HIDDEN=(8, 4), KERNELS=(5, 3), GRID=(16, 24), PADDED=(20, 28))
CELL_TOL = 1e-3  # tests/test_torch_parallel.py, bf16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _script(name, **sizes):
    """Import scripts/<name>.py as the module ``name`` (a spawned rank
    imports it by that name) with its size constants set to ``sizes``."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for k, v in sizes.items():
        setattr(mod, k, v)
    return mod


def test_bench_sharded_rollout_prints_each_cell(capsys):
    """Both cells inside the one-rank sharded rollout (gloo): one JSON line
    each, finite, the same maps (on the CPU both are the plain version)."""
    mod = _script("torch_bench_sharded_rollout", C=5, **SMALL)
    mod.main(["--device", "cpu", "--steps", "3", "--reps", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [(d["cell"], d["mode"]) for d in lines] == [("plain", "eager"), ("kernel", "eager")]
    assert all(math.isfinite(d["ms_per_step"]) and d["ms_per_step"] > 0 for d in lines)
    assert lines[0]["last_map_mean"] == lines[1]["last_map_mean"]
    assert math.isfinite(lines[0]["last_map_mean"])


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The multi-tracer demo at CPU size: its output directory and result."""
    out = str(tmp_path_factory.mktemp("multitracer"))
    mod = _script("torch_run_multitracer_demo", SEQ=4, BATCH=4, **SMALL)
    result = mod.main(["--device", "cpu", "--steps", "60", "--epochs", "1", "--chunk", "8",
                       "--out", out])
    return out, result


def test_multitracer_demo_trains_checkpoints_and_serves(demo):
    out, result = demo
    with open(os.path.join(out, "results_multitracer.json")) as f:
        assert json.load(f) == result
    for sp in ("bcb", "seasalt", "clay"):
        assert os.path.isdir(os.path.join(out, f"run_{sp}", "epoch-001"))
        assert math.isfinite(result["per_species_temporal_r2_mean"][sp])
    assert result["test_steps"] > 0 and result["aggregate_species_days_per_min"] > 0


@pytest.fixture(scope="module")
def decadal(demo, tmp_path_factory):
    """The decadal rollout on one device and sharded over (1, 2) gloo
    ranks, from the demo's checkpoints: the two results."""
    mod = _script("torch_run_decadal_rollout", SEQ=4, **SMALL)
    out = {}
    for name, extra in (("one", []), ("sharded", ["--sharded", "1", "2"])):
        d = str(tmp_path_factory.mktemp(f"decadal_{name}"))
        mod.main(["--device", "cpu", "--ckpt-root", demo[0], "--train-steps", "60",
                  "--epochs", "1", "--year-steps", "20", "--years", "2", "--chunk", "8",
                  "--out", d, *extra])
        with open(os.path.join(d, "results_decadal.json")) as f:
            out[name] = json.load(f)
    return out


def test_decadal_rollout_writes_the_jax_keys(decadal):
    one = decadal["one"]
    for key in ("config", "years", "total_steps", "serving_wall_s",
                "aggregate_species_days_per_min", "per_year_r2", "layer1_h_rms_by_year"):
        assert key in one
    assert one["total_steps"] == 2 * 20 and len(one["per_year_r2"]) == 2
    assert all(math.isfinite(r) for yr in one["per_year_r2"] for r in yr.values())
    assert all(math.isfinite(h) and h > 0 for h in one["layer1_h_rms_by_year"])


def test_decadal_rollout_sharded_matches_one_device(decadal):
    one, sh = decadal["one"], decadal["sharded"]
    assert sh["sharded"] == [1, 2] and one["sharded"] is None
    assert sh["total_steps"] == one["total_steps"]
    for a, b in zip(sh["per_year_r2"], one["per_year_r2"]):
        for sp, r in b.items():
            tol = 2 * CELL_TOL * math.sqrt(max(1.0 - r, 0.0)) + CELL_TOL ** 2
            assert abs(a[sp] - r) <= tol, (sp, a[sp], r, tol)
    # rounded to 5 decimals in the file
    np.testing.assert_allclose(sh["layer1_h_rms_by_year"], one["layer1_h_rms_by_year"],
                               rtol=0, atol=1.1e-5)


def test_per_cell_grad_cause_on_one_rank():
    """scripts/torch_per_cell_grad_cause.py at CPU size: on a one-rank
    gloo mesh the sharded per-cell step's weight gradient is the f32 sum
    of the per-call dW (the device step's calls, to f32 rounding), the
    device step's the bf16 sum of them; the biases agree in both."""
    mod = _script("torch_per_cell_grad_cause", BS=4, **SMALL)
    out = mod.main(["--device", "cpu", "--seq", "4"])
    assert [lay["cell_calls"] for lay in out["layers"]] == [4, 4]
    assert all(lay["dw_call_rel_max"] <= 1e-5 for lay in out["layers"])
    for leaf in out["leaves"]:
        if leaf["sharded_vs_f32_sum"] is not None:
            assert leaf["sharded_vs_f32_sum"] <= 1e-5, leaf
            assert math.isfinite(leaf["device_vs_f32_sum"]), leaf
        elif leaf["leaf"].endswith("/b"):
            assert leaf["sharded_vs_device"] <= 1e-5, leaf
