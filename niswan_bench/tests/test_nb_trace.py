"""The trace reader on a small synthetic Chrome trace: the union of device
intervals, the idle share, the kernel classes over the whole trace, the gaps
named by the host span, the check that the trace holds every counted
launch, and a traced run that profiles again where a trace lost records."""

import pytest

from niswan_bench import run
from niswan_bench.lib import trace

CLASSES = trace.load_classes()
CELL = "void cell_wgmma_kernel<5, 8, CellEpi<__nv_bfloat16> >(int)"
BWD = "void cell_wgmma_kernel<5, 8, BackwardEpi<__nv_bfloat16> >(int)"
DW = "void dw_mma_kernel<5, 2>(int)"
ROWS = "sum_rows_kernel(float const*)"
B3 = "void conv_same_mma_kernel<5, 2>(int)"
C = "niswan_bench.lib"


def x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def events():
    return [
        x(trace.WINDOW, "user_annotation", 100.0, 100.0),
        x("bench.unit", "user_annotation", 100.0, 60.0),
        x("bench.wait", "user_annotation", 160.0, 40.0),
        x("cudaGraphLaunch", "cuda_runtime", 150.0, 5.0),
        x(CELL, "kernel", 90.0, 20.0),     # 10 us of it inside the window
        x(CELL, "kernel", 115.0, 10.0),
        x(BWD, "kernel", 120.0, 10.0),     # overlaps the last: union 115..130
        x(DW, "kernel", 140.0, 10.0),
        x(ROWS, "kernel", 150.0, 2.0),
        x(B3, "kernel", 170.0, 5.0),
        x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 180.0, 10.0),
        x("at::native::elementwise_kernel<4>", "kernel", 195.0, 10.0),  # 5 us inside
        x(CELL, "kernel", 250.0, 5.0),     # placed after the window: still its work
    ]


def launches(b1=3, bwd=1, b3=1, dw=0):
    return {f"nasa_niswan_tpu_torch.ops.convlstm_cell.launches": b1,
            "nasa_niswan_tpu_torch.ops.convgrad.cell_bwd_launches": bwd,
            "nasa_niswan_tpu_torch.ops.convgrad.conv_same_launches": b3,
            "nasa_niswan_tpu_torch.ops.convgrad.dw_launches": dw}


def test_union_and_idle():
    s = trace.summarize(events(), CLASSES)
    # busy: 100..110, 115..130, 140..152, 170..175, 180..190, 195..200 = 57 us
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(57e-6)
    assert s["idle_frac"] == pytest.approx(0.43)
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_classes_and_counts():
    s = trace.summarize(events(), CLASSES)
    assert s["class_s"]["b1"] == pytest.approx(35e-6)   # 20 + 10 + 5, the whole launches
    assert s["class_s"]["b2a"] == pytest.approx(10e-6)
    assert s["class_s"]["dw"] == pytest.approx(12e-6)   # dW with its db helper
    assert s["class_s"]["b3"] == pytest.approx(5e-6)
    assert s["counted"] == {"b1": 3, "b2a": 1, "dw": 1, "b3": 1}
    assert trace.check_counts(s, launches(), CLASSES) == {"b1": 3, "b2a": 1, "dw": 1, "b3": 1}


@pytest.mark.parametrize("short", [dict(b1=4), dict(bwd=2), dict(b3=2), dict(dw=1)])
def test_a_short_trace_fails(short):
    s = trace.summarize(events(), CLASSES)
    with pytest.raises(trace.IncompleteTrace, match="does not hold every counted launch"):
        trace.check_counts(s, launches(**short), CLASSES)


def test_gaps_named_by_the_host():
    s = trace.summarize(events(), CLASSES)
    longest = s["idle_gaps"][0]
    assert longest[1] == pytest.approx(18e-6)  # 152..170, from within the launch call
    assert longest[0] == "bench.unit / cudaGraphLaunch"
    assert [g for _, g in s["idle_gaps"]] == pytest.approx([18e-6, 10e-6, 5e-6, 5e-6, 5e-6])
    assert s["idle_gaps"][1][0] == "bench.unit"  # 130..140
    names = [n for n, _ in s["device_ops"]]
    assert names[0].startswith("cell_wgmma_kernel<5, 8, CellEpi")


def test_a_cell_kernel_without_its_epilogue_fails():
    bad = events() + [x("void cell_wgmma_kernel<5, 8, OtherEpi>(int)", "kernel", 130.0, 1.0)]
    with pytest.raises(trace.TraceError, match="epilogue"):
        trace.summarize(bad, CLASSES)


def test_one_window_span():
    with pytest.raises(trace.IncompleteTrace, match="one 'bench.window'"):
        trace.summarize(events()[1:], CLASSES)


def flaky_profile(monkeypatch, lost):
    """``run.profile_once`` losing records on its first ``lost`` calls."""
    calls = []

    def once(drv, traffic, device):
        calls.append(len(calls))
        if len(calls) <= lost:
            raise trace.IncompleteTrace("the trace does not hold every counted launch")
        return "summary", {"units": 1}, {"b1": 3}

    monkeypatch.setattr(run, "profile_once", once)
    return calls


@pytest.mark.parametrize("lost", range(run.TRACE_ATTEMPTS))
def test_a_trace_that_lost_records_is_profiled_again(monkeypatch, lost):
    calls = flaky_profile(monkeypatch, lost)
    assert run.profiled(None, {}, None) == ("summary", {"units": 1}, {"b1": 3})
    assert len(calls) == lost + 1


def test_a_trace_that_keeps_losing_records_fails_the_run(monkeypatch):
    calls = flaky_profile(monkeypatch, run.TRACE_ATTEMPTS)
    with pytest.raises(trace.IncompleteTrace):
        run.profiled(None, {}, None)
    assert len(calls) == run.TRACE_ATTEMPTS


def test_a_faulty_kernel_name_is_not_profiled_again(monkeypatch):
    calls = []

    def once(drv, traffic, device):
        calls.append(1)
        raise trace.TraceError("a cell kernel whose epilogue is not in its name")

    monkeypatch.setattr(run, "profile_once", once)
    with pytest.raises(trace.TraceError, match="epilogue"):
        run.profiled(None, {}, None)
    assert len(calls) == 1
