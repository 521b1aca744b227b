"""The graph runner (graph.py) on the serving side, on the CPU: every
serving entry point on ``fake_cuda_graph.FakeGraph`` for its CUDA graph,
against its own eager body.

* A chunk warms up on its first step, captures once and replays: its
  outputs and carry equal ``rollout.eager``'s over chained calls.
* An in-place parameter change recaptures a runner with a ``weights``
  hook, and a repeat call does not; a runner without the hook reads its
  parameters live and does not recapture.
* k in-line steps equal k eager steps, and their carry stays in the
  runner's static buffers.
* After k replays the launch counters read k times the captured launches.

B1's launches are counted on the CPU by a counting wrapper around its
plain version (the CPU route of ``fused_cell_forward``).

Shapes: 2 layers, hidden (4, 3), kernels (3, 3), 8 input channels, grid
(16, 24) padded to (20, 28), B 2; one intra-op thread.  This file imports
no JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch import graph, ops  # noqa: E402
from nasa_niswan_tpu_torch.data.dataset import Normalizer  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.ops import convlstm_cell  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import (  # noqa: E402
    make_rollout_fn,
    make_streaming_rollout,
)

import fake_cuda_graph  # noqa: E402  (tests/ is on the path)

CFG = ConvLSTMConfig(in_channels=8, hidden_channels=(4, 3), kernel_sizes=(3, 3))
GEO = dict(padded_shape=(20, 28), grid_shape=(16, 24))
LAYERS, B, T = 2, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fake(monkeypatch):
    """The stand-in graph, and B1's plain version counted as a launch."""
    plain = convlstm_cell.fused_cell_forward_plain

    def counted(*args, **kw):
        convlstm_cell.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(convlstm_cell, "fused_cell_forward_plain", counted)
    monkeypatch.setattr(convlstm_cell, "launches", 0)
    return fake_cuda_graph.install(monkeypatch)


def _setup(seed=0):
    params = convlstm_init(torch.Generator().manual_seed(seed), CFG)
    rng = np.random.default_rng(seed)
    norm = Normalizer(rng.standard_normal(8).astype(np.float32),
                      (1.0 + rng.random(8)).astype(np.float32), 0.5, 2.0)
    forcings = torch.tensor(rng.standard_normal((4, B, T, 8, 16, 24)), dtype=torch.float32)
    return params, norm, forcings


def _launches():
    return ops.launch_counts()["nasa_niswan_tpu_torch.ops.convlstm_cell.launches"]


def _same(a, b):
    return all(torch.equal(x, y) for hc_a, hc_b in zip(a, b) for x, y in zip(hc_a, hc_b))


def test_chunk_warms_on_its_first_step_captures_once_and_replays(fake):
    """The first call runs one step eagerly (the warm-up), captures and
    replays the chunk; chained calls equal ``rollout.eager``'s, predictions
    and carry, with one capture."""
    params, norm, forcings = _setup()
    rollout = make_rollout_fn(CFG, norm, **GEO)
    st_g = st_e = None
    for k, f in enumerate(forcings):
        before = _launches()
        p_g, st_g = rollout(params, f, st_g)
        if k == 0:  # one warm-up step, the capture taken back, one replay
            assert _launches() - before == LAYERS + LAYERS * T
        p_e, st_e = rollout.eager(params, f, st_e)
        assert torch.equal(p_g, p_e) and _same(st_g, st_e)
    assert rollout.runner.captures == 1 and len(fake.graphs) == 1


def test_in_place_update_recaptures_only_a_runner_with_a_weights_hook(fake):
    """A version change of a parameter leaf recaptures the chunk (its
    graph reads weights made before the capture), and the new graph
    serves the new weights; a repeat call does not recapture.  A runner
    without the hook keys on the leaves alone and serves the update
    live."""
    params, norm, forcings = _setup()
    rollout = make_rollout_fn(CFG, norm, **GEO)
    rollout(params, forcings[0])
    rollout(params, forcings[0])
    assert rollout.runner.captures == 1
    with torch.no_grad():
        params["cells"][0]["w_h"].mul_(0.5)
    got, _ = rollout(params, forcings[0])
    want, _ = rollout.eager(params, forcings[0])
    assert torch.equal(got, want) and rollout.runner.captures == 2
    rollout(params, forcings[1])
    assert rollout.runner.captures == 2

    live = graph.Graphed(lambda p, x: (x * p["w"],))
    p, x = {"w": torch.full((3,), 2.0)}, torch.arange(3.0)
    live(p, x)
    with torch.no_grad():
        p["w"].add_(1.0)
    (y,) = live(p, x)
    assert torch.equal(y, x * 3.0) and live.captures == 1


def test_inline_steps_equal_eager_steps_and_keep_the_carry_in_the_buffers(fake):
    """k in-line calls (the first eager and captured, the rest replays)
    equal k eager steps of the rollout, each prediction and the carry;
    after every call the carry is the runner's static input buffers."""
    params, norm, forcings = _setup()
    step = make_streaming_rollout(CFG, norm, params, **GEO)
    frames = forcings[0]  # (B, T, C, H, W)
    want, st = make_rollout_fn(CFG, norm, **GEO).eager(params, frames)
    for t in range(T):
        assert torch.equal(step(frames[:, t]), want[:, t])
        carry = [x for hc in step.carry() for x in hc]
        assert all(a is b for a, b in zip(carry, step.runner.last_inputs[1:]))
    assert _same(step.carry(), st) and step.runner.captures == 1


@pytest.mark.parametrize("entry", ["chunk", "inline"])
def test_launch_counts_after_k_replays_are_k_captures(fake, entry):
    """Each replay adds the launches counted while capturing, once: after
    the first call, k calls read k times a chunk's (layers × steps) or an
    in-line step's (layers) launches."""
    params, norm, forcings = _setup()
    if entry == "chunk":
        rollout = make_rollout_fn(CFG, norm, **GEO)
        call, per_replay = (lambda f: rollout(params, f)), LAYERS * T
    else:
        step = make_streaming_rollout(CFG, norm, params, **GEO)
        call, per_replay = (lambda f: step(f[:, 0])), LAYERS
    call(forcings[0])
    before = _launches()
    for f in forcings[1:]:
        call(f)
    assert _launches() - before == (len(forcings) - 1) * per_replay
