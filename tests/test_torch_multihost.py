"""A multi-host run of the port with two real OS processes, the twin of
tests/test_multihost.py.

Two independent processes of scripts/torch_multihost_worker.py join one
gloo process group through ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` 0 and ``LOCAL_WORLD_SIZE`` 1: each
is the only rank of its "host") and run, every rank the same code, one
data-parallel train step on a (2,) mesh (each feeding its own half of the
batch), two chained chunks of the sharded rollout on (1, 1, 2) and two of
the sharded closed loop on (1, 2, 1): halo messages, the gradient
all-reduce and the feedback gather cross the process boundary.

Rank 0's numbers are held against
* the port in one process (the worker's functions without a mesh:
  ``make_train_step`` on the global batch, ``make_rollout_fn`` over the
  chunks, ``make_closed_loop_chunk`` through ``run_chunked_episode_carry``),
  to 1e-6 relative: the same f32 arithmetic but for the order of the
  all-reduced sums;
* the JAX worker's ``run_dp_step``, ``run_spatial_rollout`` and
  ``run_feedback_rollout`` on the 8 CPU devices of tests/conftest.py
  (``make_mesh(dp=2, lat=2, lon=2)``), on the same weights (drawn by JAX,
  handed to the workers as npz files), to 1e-5 relative: XLA's conv and
  the port's plain cell sum in other orders."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu.models import convlstm as jm  # noqa: E402
from nasa_niswan_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from nasa_niswan_tpu.parallel import mesh as jmesh  # noqa: E402
from nasa_niswan_tpu_torch import bridge  # noqa: E402

from test_torch_campaign_scripts import SCRIPTS, _script  # noqa: E402

KEYS = {"dp": ("loss", "r2"), "spatial": ("pred_mean", "pred_std"),
        "feedback": ("fb_mean", "fb_std")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX worker's three parameter sets (its PRNG keys), one npz each,
    keyed by leaf path."""
    d = tmp_path_factory.mktemp("multihost_weights")
    trees = {
        "dp": jax_build_model("LSTM", in_channels=5, hidden_channels=(4, 4),
                              kernel_sizes=(3, 3), remat=False).init(
            jax.random.PRNGKey(0))[0],
        "spatial": jm.convlstm_init(jax.random.PRNGKey(2), jm.ConvLSTMConfig(5, (4, 4), (3, 3))),
        "feedback": jm.convlstm_init(jax.random.PRNGKey(4),
                                     jm.ConvLSTMConfig(6, (4, 4), (3, 3))),
    }
    for name, tree in trees.items():
        np.savez(d / f"{name}.npz", **{p: np.asarray(a) for p, a in
                                       zip(bridge.tree_paths(tree), bridge.tree_leaves(tree))})
    return str(d)


@pytest.fixture(scope="module")
def rank0(weights):
    """Rank 0's JSON line from two worker processes on gloo."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(SCRIPTS, "torch_multihost_worker.py"), "--port",
             str(port), "--rank", str(r), "--world-size", "2", "--device", "cpu",
             "--weights", weights],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    assert outs[1][0].strip() == ""  # rank 1 prints nothing
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def one_process(weights):
    """The worker's functions without a mesh, in this process."""
    w = _script("torch_multihost_worker")
    loss, r2, _ = w.run_dp_step(None, weights)
    pmean, pstd = w.run_spatial_rollout(None, weights)
    fmean, fstd = w.run_feedback_rollout(None, weights)
    return dict(loss=loss, r2=r2, pred_mean=pmean, pred_std=pstd, fb_mean=fmean,
                fb_std=fstd)


@pytest.fixture(scope="module")
def jax_worker():
    """The JAX worker's numbers on the in-process 8-device CPU mesh."""
    w = _script("multihost_worker")
    mesh = jmesh.make_mesh(dp=2, lat=2, lon=2)
    out = dict(zip(KEYS["dp"], w.run_dp_step(mesh)))
    out.update(zip(KEYS["spatial"], w.run_spatial_rollout(mesh)))
    out.update(zip(KEYS["feedback"], w.run_feedback_rollout(mesh)))
    return out


@pytest.mark.parametrize("part", list(KEYS))
def test_two_processes_match_one_process(rank0, one_process, part):
    for key in KEYS[part]:
        assert rank0[key] == pytest.approx(one_process[key], rel=1e-6), key


@pytest.mark.parametrize("part", list(KEYS))
def test_two_processes_match_the_jax_worker(rank0, jax_worker, part):
    for key in KEYS[part]:
        assert rank0[key] == pytest.approx(jax_worker[key], rel=1e-5), key


def test_ranks_ran_the_plain_versions_on_the_cpu(rank0):
    """On the CPU every wrapper runs its plain version: no kernel launch is
    counted in the worker."""
    assert rank0["launches"] and not any(rank0["launches"].values())
