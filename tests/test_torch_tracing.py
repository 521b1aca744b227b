"""The port's spans and counters (utils/profiling.py) on the CPU.

* Outside a profiler a span is the shared no-op: it keeps no record and
  enters no ``record_function``, on its own and on the port's paths.
* Inside ``utils/profiling.trace``, nested spans keep their names, parents
  and host times, and the Chrome trace holds each as a ``user_annotation``
  nested as they were.
* The graph runner on a CPU stand-in for a CUDA graph records
  ``niswan.graph.run``, ``.stage`` and ``.replay`` on replays and
  ``niswan.train.upload`` around ``DeviceWindowSource.prepare``;
  ``graph.capture_s`` grows on a signature's first call only.
* The streaming step on the CPU records ``niswan.serve.step`` and
  ``niswan.serve.upload`` and returns what it returns untraced.
* The record list keeps at most ``MAX_SPANS`` records, the newest.

Shapes: 2 layers, hidden (4, 3), kernels (3, 3), 7 input channels, T = 3,
grid (16, 24) padded to (20, 28), batch 2; one intra-op thread.  This file
imports no JAX."""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch.data.dataset import Normalizer, SequenceDataset  # noqa: E402
from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d  # noqa: E402
from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init  # noqa: E402
from nasa_niswan_tpu_torch.models.registry import build_model  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_streaming_rollout  # noqa: E402
from nasa_niswan_tpu_torch.train import loop as tloop  # noqa: E402
from nasa_niswan_tpu_torch.utils import profiling  # noqa: E402
from nasa_niswan_tpu_torch.utils.profiling import counters, span, spans, trace  # noqa: E402

import fake_cuda_graph  # noqa: E402  (tests/ is on the path)

MODEL = dict(in_channels=7, hidden_channels=(4, 3), kernel_sizes=(3, 3))
GEO = dict(padded_shape=(20, 28), grid_shape=(16, 24))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_record_function(monkeypatch):
    """``record_function`` raises: a span that enters one fails the test."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _counts(*names):
    return [len(spans(n)) for n in names]


def _streaming(seed=0):
    cfg = ConvLSTMConfig(in_channels=8, hidden_channels=(4, 3), kernel_sizes=(3, 3))
    params = convlstm_init(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    norm = Normalizer(rng.standard_normal(8).astype(np.float32),
                      (1.0 + rng.random(8)).astype(np.float32), 0.5, 2.0)
    frames = torch.tensor(rng.standard_normal((3, 2, 8, 16, 24)), dtype=torch.float32)
    return make_streaming_rollout(cfg, norm, params, device="cpu", **GEO), frames


def test_span_outside_a_profiler_is_the_shared_no_op(no_record_function):
    before = _counts("t.off")
    assert span("t.off") is span("t.other", device=True)
    with span("t.off"):
        with span("t.off", device=True):
            pass
    assert _counts("t.off") == before
    step, frames = _streaming()
    names = ("niswan.serve.step", "niswan.serve.upload", "niswan.serve.chunk")
    before = _counts(*names)
    step(frames[0])
    assert _counts(*names) == before


def test_counter_span_outside_a_profiler_times_without_recording(no_record_function):
    c0 = counters()["graph.capture_s"]
    n0 = len(spans("t.counted"))
    with span("t.counted", counter="graph.capture_s"):
        sum(range(1000))
    assert counters()["graph.capture_s"] > c0
    assert len(spans("t.counted")) == n0


def test_nested_spans_in_a_trace(tmp_path):
    x = torch.ones(64, 64)
    with trace(str(tmp_path)):
        with span("t.outer"):
            for _ in range(2):
                with span("t.inner", device=True):
                    x = x @ x / 64
    outer, = spans("t.outer")[-1:]
    inners = spans("t.inner")[-2:]
    assert outer.parent is None
    for r in inners:
        assert r.parent is outer and r.device_s is None  # no card: host time only
        assert outer.start_ns <= r.start_ns < r.end_ns <= outer.end_ns
    assert inners[0].end_ns <= inners[1].start_ns
    assert outer.host_s >= sum(r.host_s for r in inners) > 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = {n: [e for e in events if e.get("cat") == "user_annotation" and e["name"] == n]
           for n in ("t.outer", "t.inner")}
    assert len(ann["t.outer"]) == 1 and len(ann["t.inner"]) == 2
    o = ann["t.outer"][0]
    for e in ann["t.inner"]:
        assert o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]


@pytest.fixture
def device_step(monkeypatch):
    """``make_device_train_step`` over a tiny resident slab, its runner on
    ``fake_cuda_graph.FakeGraph``; returns (step, params, window starts)."""
    fake_cuda_graph.install(monkeypatch)
    data = synthetic_e33oma_90d(T=40, H=16, W=24, seed=3)
    ds = SequenceDataset(data, period="train", sequence_length=3, in_channels=7)
    bundle = build_model("LSTM-g", **MODEL)
    params, _ = bundle.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    opt = tloop.make_optimizer(params, 1e-3, (0.5, 0.999))
    source = tloop.DeviceWindowSource(ds, "cpu")
    step = tloop.make_device_train_step(bundle, ds.normalizer, opt, source,
                                        static=data["static"][:2], **GEO)
    return step, params, [np.array([0, 2]), np.array([1, 3]), np.array([4, 0])]


GRAPH = ("niswan.train.step", "niswan.train.upload", "niswan.graph.run",
         "niswan.graph.capture", "niswan.graph.stage", "niswan.graph.replay")


def test_step_graph_spans_on_replays(device_step, tmp_path):
    step, params, starts = device_step
    before = _counts(*GRAPH)
    with trace(str(tmp_path)):
        for s in starts:
            step(params, None, s)
    got = [a - b for a, b in zip(_counts(*GRAPH), before)]
    assert got == [3, 3, 3, 1, 2, 2]
    steps = spans("niswan.train.step")[-3:]
    uploads = spans("niswan.train.upload")[-3:]
    runs = spans("niswan.graph.run")[-3:]
    capture, = spans("niswan.graph.capture")[-1:]
    assert [u.parent for u in uploads] == steps and [r.parent for r in runs] == steps
    assert capture.parent is runs[0]
    for name in ("niswan.graph.stage", "niswan.graph.replay"):
        assert [r.parent for r in spans(name)[-2:]] == runs[1:]
    for u, r in zip(uploads, runs):
        assert u.end_ns <= r.start_ns  # the upload comes before the runner
    assert all(r.device_s is None for r in spans("niswan.graph.replay")[-2:])


def test_capture_counter_grows_on_the_first_call_only(device_step):
    step, params, starts = device_step
    c0 = counters()["graph.capture_s"]
    step(params, None, starts[0])
    c1 = counters()["graph.capture_s"]
    assert c1 > c0
    step(params, None, starts[1])
    step(params, None, starts[2])
    assert counters()["graph.capture_s"] == c1
    assert step.runner.captures == 1


def test_streaming_step_spans_on_the_cpu(tmp_path):
    names = ("niswan.serve.step", "niswan.serve.upload", "niswan.serve.chunk")
    plain, frames = _streaming()
    traced, _ = _streaming()
    before = _counts(*names)
    with trace(str(tmp_path)):
        got = [traced(f) for f in frames]
    want = [plain(f) for f in frames]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [a - b for a, b in zip(_counts(*names), before)] == [3, 3, 3]
    steps = spans("niswan.serve.step")[-3:]
    assert [r.parent for r in spans("niswan.serve.upload")[-3:]] == steps
    assert [r.parent for r in spans("niswan.serve.chunk")[-3:]] == steps  # the eager route


def test_record_list_stays_within_its_cap(monkeypatch, tmp_path):
    assert profiling.MAX_SPANS == 100_000 and profiling._records.maxlen == profiling.MAX_SPANS
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=5))
    with trace(str(tmp_path)):
        for i in range(8):
            with span(f"t.cap{i % 2}"):
                pass
    assert len(profiling._records) == 5
    assert [r.name for r in profiling._records] == ["t.cap1", "t.cap0"] * 2 + ["t.cap1"]
    assert len(spans("t.cap0")) == 2 and len(spans("t.cap1")) == 3
