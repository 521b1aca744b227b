"""A run of each runner, past the look for a chip, on the CPU at a tiny size
in f32: sound, ``correct`` comes out true; with the timed path broken
underneath (lib/faults.py), false.  The runners of cells that BENCHMARK.json
does not hold yet run too, with the limits of the cell of their kind."""

import pytest
import torch

from niswan_bench import run
from niswan_bench.lib import faults, spec
from niswan_bench.tests import tiny

BENCH = spec.benchmark()
# cell: (configuration, traffic, the cell whose limits it is held to)
CELLS = {
    "serve_l20_chunked": ("convlstm_l20_62c", "chained_384", "serve_l20_chunked"),
    "serve_l20_inline": ("convlstm_l20_62c", "inline_pinned48", "serve_l20_chunked"),
    "train_surface_remat": ("convlstm_surface_8c", "resident_year", "train_surface_remat"),
}
SERVING = [c for c in CELLS if c.startswith("serve")]
TRAINING = [c for c in CELLS if c.startswith("train")]
SEED = 2 ** 31 + 99


def run_tiny(name, trace=False):
    config, traffic, limits = CELLS[name]
    cell = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    cfg = dict(tiny.config(config), compute_dtype="float32")
    result, _ = run.run_cell(BENCH, cell, cfg, tiny.traffic(traffic), spec.limits(limits),
                             seed=SEED, seconds=0.3, trace=trace,
                             device=torch.device("cpu"))
    return result


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_runs_are_correct(cell):
    result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert list(result)[-1] == "checks"


def test_a_traced_run_reads_its_layers_on_the_cpu():
    result = run_tiny("serve_l20_chunked", trace=True)
    assert result["correct"]
    assert result["metrics"]["device_idle.serve"]["value"] == pytest.approx(100.0)
    assert "cell_fwd_roofline.serve" not in result["metrics"]  # no kernel launched here
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("kind", faults.SERVING)
@pytest.mark.parametrize("cell", SERVING)
def test_serving_faults_fail(cell, kind):
    with faults.planted(kind, "serve"):
        assert not run_tiny(cell)["correct"]


@pytest.mark.parametrize("kind", faults.TRAINING)
@pytest.mark.parametrize("cell", TRAINING)
def test_training_faults_fail(cell, kind):
    with faults.planted(kind, "train"):
        assert not run_tiny(cell)["correct"]


def test_a_gradient_altered_in_the_replayed_steps_alone_fails_grad_err():
    """On a card only steps 2 and 3 of the checked three are graph replays,
    as every step of the window is: a fault there alone has to show."""
    with faults.planted("grad_altered_late", "train"):
        checks = run_tiny("train_surface_remat")["checks"]
    assert checks["grad_err"]["value"] > checks["grad_err"]["limit"]
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
    assert checks["change_gap"]["value"] <= checks["change_gap"]["limit"]
