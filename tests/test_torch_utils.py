"""The port's run utilities (nasa_niswan_tpu_torch/utils/) against the JAX
package's (nasa_niswan_tpu/utils/): the run log's format and the training
CLI's ``logger.log``, seeding, the throughput meter's keys, tracing, the
device sync, and ``layer_summary`` line for line on the same parameter
trees (the canonical ConvLSTM, 580,305 parameters as in the reference's
notebook, and a UNet)."""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cli_utils import cpu_env  # noqa: E402

from nasa_niswan_tpu.models.convlstm import ConvLSTMConfig as JConvLSTMConfig  # noqa: E402
from nasa_niswan_tpu.models.convlstm import convlstm_init as j_convlstm_init  # noqa: E402
from nasa_niswan_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from nasa_niswan_tpu.models.unet import unet_init as j_unet_init  # noqa: E402
from nasa_niswan_tpu.utils.logging import LoggerDecorator as JLoggerDecorator  # noqa: E402
from nasa_niswan_tpu.utils.profiling import layer_summary as j_layer_summary  # noqa: E402
from nasa_niswan_tpu.utils.profiling import StepTimer as JStepTimer  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402
from nasa_niswan_tpu_torch.utils import LoggerDecorator, run_logger, seed_rng  # noqa: E402
from nasa_niswan_tpu_torch.utils.profiling import (  # noqa: E402
    StepTimer,
    device_sync,
    layer_summary,
    trace,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^INFO \d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} Run configuration: "
                  r"\(\(1,\), \{'b': 3\}\), Elapsed time: \d+:\d\d:\d\d(\.\d+)?$")


def test_logger_decorator_writes_the_jax_format(tmp_path):
    """Both packages' decorators write one line of the same form."""
    for name, deco in (("port", LoggerDecorator), ("jax", JLoggerDecorator)):
        log = tmp_path / f"{name}.log"

        @deco(str(log))
        def job(a, b=2):
            return a + b

        assert job(1, b=3) == 4
        lines = log.read_text().splitlines()
        assert len(lines) == 1 and LINE.match(lines[0]), lines
    assert run_logger().name == "nasa_niswan_tpu_torch"


def test_logger_decorator_logs_a_failed_run(tmp_path):
    log = tmp_path / "fail.log"

    @LoggerDecorator(str(log))
    def job():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        job()
    assert "Elapsed time" in log.read_text()
    assert not run_logger().handlers  # the handler is removed


def test_train_cli_writes_logger_log(tmp_path):
    """``python -m nasa_niswan_tpu_torch.train`` writes logger.log beside
    configurations.json, as the JAX CLI does."""
    snap = tmp_path / "snap"
    env = dict(cpu_env(), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    out = subprocess.run(
        [sys.executable, "-m", "nasa_niswan_tpu_torch.train", "--device", "cpu",
         "--model", "LSTM-log", "--hidden-channels", "4", "--kernel-size", "3",
         "--num-layers", "1", "--sequence-length", "3", "--num-epochs", "1",
         "--batch-size", "4", "--input-size", "20", "28", "--synthetic-steps", "60",
         "--synthetic-grid", "16", "24", "--checkpoint-every", "0",
         "--snapshot-dir", str(snap)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    text = (snap / "logger.log").read_text()
    assert text.startswith("INFO ") and "Run configuration: ((TrainConfig(" in text
    assert "Elapsed time" in text
    assert json.load(open(snap / "configurations.json"))["model"] == "LSTM-log"


def test_seed_rng_seeds_every_generator():
    g1 = seed_rng(5, device="cpu")
    a = (np.random.rand(3), torch.rand(3), torch.rand(3, generator=g1))
    import random

    r1 = random.random()
    g2 = seed_rng(5, device="cpu")
    b = (np.random.rand(3), torch.rand(3), torch.rand(3, generator=g2))
    assert random.random() == r1
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert g2.device == torch.device("cpu") and g2.initial_seed() == 5
    with pytest.raises(TypeError):
        seed_rng(0)  # the generator's device is explicit


def test_step_timer_keys_match_jax():
    """On the CPU the meter reads perf_counter; its records and summary
    carry the JAX meter's keys."""
    timer, jtimer = StepTimer(steps_per_day=48, sync_every=2), JStepTimer(48, 2)
    x = torch.ones(4)
    for _ in range(6):
        timer.tick({"loss": x}, n_steps=48, batch=2)
        jtimer.tick(np.ones(4), n_steps=48, batch=2)
    s, js = timer.summary(), jtimer.summary()
    assert s.keys() == js.keys() and s["windows"] == js["windows"] == 2
    assert s["model_days_per_min"] > 0
    assert timer.records[0].keys() == jtimer.records[0].keys()
    assert timer.records[0]["model_days"] == 4.0
    empty = StepTimer().summary()
    assert empty["windows"] == 0 and np.isnan(empty["model_days_per_min"])
    device_sync({"a": [x]})  # the CPU has nothing to wait for
    device_sync({})


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("model", ["convlstm", "unet"])
def test_layer_summary_matches_jax(model):
    if model == "convlstm":
        jparams = j_convlstm_init(jax.random.PRNGKey(0), JConvLSTMConfig(5, (64, 32, 16),
                                                                         (5, 3, 3)))
    else:
        jparams, _ = j_unet_init(jax.random.PRNGKey(0), JUNetConfig(5, 1, (4, 8, 16, 32)))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    table = layer_summary(params)
    assert table == j_layer_summary(jparams)
    if model == "convlstm":
        assert "580,305" in table and "cells/0/w_x" in table
