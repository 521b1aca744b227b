"""The control at each cell's own size, on a card: the reference at fp8
put in the port's place, over a window at the cell's load, must come out
not correct.  Skipped without a card."""

import pytest
import torch

from niswan_bench.lib import compare, spec

BENCH = spec.benchmark()
CONTROL_SECONDS = 12  # long enough for a serving window to reach the chunk drawn from the seed


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(cell, card):
    c = spec.cell(BENCH, cell)
    traffic = spec.traffic(c["traffic"])
    drv = spec.runner(traffic["runner"]).Runner(spec.config(c["config"]), traffic, 201, card,
                                                system="control")
    drv.setup()
    drv.run(seconds=CONTROL_SECONDS)  # the control runs ~4x slower than the port
    drv.release()
    values, _ = drv.check()
    assert not compare.verdict(values, spec.limits(cell)), values
