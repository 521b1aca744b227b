"""The port's training command line (``python -m nasa_niswan_tpu_torch.train``)
against the JAX package's: the canonical command of docs/REALDATA.md, as
written there, parses in both packages to equal configurations apart from
the port's ``device``; ``--cell-impl`` is recorded (the JAX key, default
"auto") and ignored by the port; a configurations.json written by either
package loads in the other with ``cell_impl`` kept."""

import dataclasses
import os
import re
import shlex

import pytest

from nasa_niswan_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from nasa_niswan_tpu.train.config import parse_args as j_parse_args  # noqa: E402
from nasa_niswan_tpu_torch.train.config import TrainConfig, parse_args  # noqa: E402

REALDATA = os.path.join(os.path.dirname(__file__), "..", "docs", "REALDATA.md")


def _realdata_command():
    """The arguments of docs/REALDATA.md's canonical training command (the
    ``python -m nasa_niswan_tpu.train`` block that passes ``--cell-impl``)."""
    with open(REALDATA) as f:
        text = f.read()
    for m in re.finditer(r"python -m nasa_niswan_tpu\.train \\\n(.*?)\n```", text, re.S):
        argv = shlex.split(m.group(1).replace("\\\n", " "))
        if "--cell-impl" in argv:
            return argv
    raise AssertionError("no training command with --cell-impl in docs/REALDATA.md")


def _shared(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JTrainConfig)}


def test_realdata_command_parses_in_both_packages():
    argv = _realdata_command()
    assert argv[argv.index("--cell-impl") + 1] == "auto"
    cfg, jcfg = parse_args(argv), j_parse_args(argv)
    assert _shared(cfg) == _shared(jcfg)
    assert cfg.cell_impl == "auto" and cfg.device == "cuda"
    assert cfg.compute_dtype == "bfloat16" and cfg.batch_size == 8
    assert cfg.sequence_length == 48 and cfg.input_size == (100, 154)
    # the flag changes nothing but the recorded key
    i = argv.index("--cell-impl")
    without = argv[:i] + argv[i + 2:]
    assert parse_args(without) == cfg
    assert parse_args([*without, "--cell-impl", "pallas2"]) == dataclasses.replace(
        cfg, cell_impl="pallas2")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_configurations_json_carries_cell_impl(tmp_path, writer):
    kw = dict(cell_impl="pallas2", compute_dtype="bfloat16", levels=20,
              snapshot_dir=str(tmp_path))
    write, read = (JTrainConfig, TrainConfig) if writer == "jax" else (TrainConfig, JTrainConfig)
    written = write(**kw)
    loaded = read.load(written.dump())
    assert loaded.cell_impl == "pallas2"
    assert _shared(loaded) == _shared(written)
