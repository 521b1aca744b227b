"""The readers of the port's spans and counters (lib/program.py and the
metrics that read it) on synthetic port records: each returns the mean or
share it documents, reads only the profiled sub-window's last ``units``
records, and returns None where the span or the port's tracing is missing."""

from types import SimpleNamespace

import pytest

from niswan_bench.lib import program, spec

SPAN_METRICS = {  # metric: (span, scale of host seconds, or None for a device share)
    "inline.upload_us": ("niswan.serve.upload", 1e6),
    "inline.dispatch_us": ("niswan.graph.run", 1e6),
    "train.upload_ms": ("niswan.train.upload", 1e3),
    "inline.replay_share": ("niswan.graph.replay", None),
    "serve.replay_share": ("niswan.graph.replay", None),
    "train.replay_share": ("niswan.graph.replay", None),
}
COUNTER_METRICS = {"setup.capture_s": "graph.capture_s",
                   "setup.kernel_load_s": "kernels.load_s"}


class Record:
    def __init__(self, name, host_s, device_s=None):
        self.name, self.host_s, self.device_s = name, host_s, device_s


class Port:
    """A stand-in for the port's ``utils/profiling``."""

    def __init__(self, records, counters=None):
        self.records, self._counters = records, counters or {}

    def spans(self, name):
        return [r for r in self.records if r.name == name]

    def counters(self):
        return dict(self._counters)


def records(name, host, device=None):
    device = device or [None] * len(host)
    return [Record(name, h, d) for h, d in zip(host, device)]


def ctx(units=3, window_s=0.5):
    return SimpleNamespace(trace={"window_s": window_s}, trace_window={"units": units})


@pytest.fixture
def port(monkeypatch):
    def use(recs, counters=None):
        monkeypatch.setattr(program, "profiling", lambda: Port(recs, counters))
    return use


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_reads_the_last_units_records(port, metric):
    name, scale = SPAN_METRICS[metric]
    # an earlier sub-window that lost records (5 units), then the one read (3)
    host = [9.0] * 5 + [0.001, 0.002, 0.006]
    device = [9.0] * 5 + [0.05, 0.10, 0.15]
    port(records(name, host, device) + records("niswan.other", [7.0] * 4, [7.0] * 4))
    got = spec.reader(metric).read(ctx(units=3, window_s=0.5))
    want = 0.003 * scale if scale else 100.0 * 0.30 / 0.5
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_none_where_the_span_is_missing_or_short(port, metric):
    name, _ = SPAN_METRICS[metric]
    port(records("niswan.other", [1.0] * 3, [1.0] * 3))
    assert spec.reader(metric).read(ctx()) is None
    port(records(name, [1.0] * 2, [1.0] * 2))  # fewer records than units
    assert spec.reader(metric).read(ctx(units=3)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS) + sorted(COUNTER_METRICS))
def test_none_without_the_ports_tracing(monkeypatch, metric):
    monkeypatch.setattr(program, "profiling", lambda: None)
    assert spec.reader(metric).read(ctx()) is None


def test_a_port_without_spans_reads_as_none(monkeypatch):
    """A port older than its spans has ``utils/profiling`` without
    ``spans`` and ``counters``."""
    import nasa_niswan_tpu_torch.utils.profiling as prof

    monkeypatch.delattr(prof, "spans")
    assert program.profiling() is None
    assert spec.reader("setup.capture_s").read(ctx()) is None
    monkeypatch.undo()
    assert program.profiling() is prof


@pytest.mark.parametrize("metric", ["inline.replay_share", "serve.replay_share",
                                    "train.replay_share"])
def test_share_needs_device_times_and_a_trace(port, metric):
    port(records("niswan.graph.replay", [0.1] * 3))  # host times only
    assert spec.reader(metric).read(ctx()) is None
    port(records("niswan.graph.replay", [0.1] * 3, [0.1] * 3))
    c = ctx()
    c.trace = None
    assert spec.reader(metric).read(c) is None


@pytest.mark.parametrize("metric", sorted(COUNTER_METRICS))
def test_counters(port, metric):
    port([], {"graph.capture_s": 2.5, "kernels.load_s": 0.75})
    want = {"graph.capture_s": 2.5, "kernels.load_s": 0.75}[COUNTER_METRICS[metric]]
    assert spec.reader(metric).read(ctx()) == want


def test_readers_on_the_ports_own_records(tmp_path):
    """The port's real records: a traced span reads back through the helper."""
    from nasa_niswan_tpu_torch.utils.profiling import span, trace

    with trace(str(tmp_path)):
        for _ in range(4):
            with span("niswan.bench_test"):
                pass
    got = program.mean_host_s(ctx(units=4), "niswan.bench_test")
    assert got is not None and 0 < got < 1.0
    assert program.counter("kernels.load_s") is not None


def test_new_entries_name_accepted_cells_only():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS or m["name"] in COUNTER_METRICS:
            assert set(m["workloads"]) <= cells and m["workloads"]
