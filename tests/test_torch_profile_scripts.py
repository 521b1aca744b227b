"""The port's profiling and benchmark scripts (scripts/torch_trace_summary.py,
torch_profile_rollout.py, torch_profile_closed_loop.py,
torch_profile_seq2seq.py, torch_bench_cell.py, torch_bench_ncread.py and
profile_torch_train_step.py) on the CPU (``--device cpu``) at a size a
one-thread CPU takes: a 16 x 24 grid padded to 20 x 28, hidden (8, 4),
kernels (5, 3), at most 6 steps.  The sizes are the scripts' module
constants, set here; their defaults stay the JAX scripts'.

The trace summary's analytic FLOPs equal the JAX script's
(scripts/trace_summary.conv_gflops_per_step) to 1e-12 relative; its parser
runs on a real CPU trace of utils/profiling.trace and gives the interval
union, the split by kernel and the top ops exactly on a hand-made Chrome
trace.  Every other script returns the JAX script's keys, every number
finite.  The feedback-pad ablation restores ``fb_channel`` also when the
step raises; the native netCDF reader gives scipy's arrays bit for bit.
No script imports JAX or the JAX package, and each one asked for the card
without one raises."""

import ast
import gzip
import importlib.util
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch.core.padding import pad_geo  # noqa: E402
from nasa_niswan_tpu_torch.ops import seq2seq_bptt  # noqa: E402
from nasa_niswan_tpu_torch.utils.profiling import trace  # noqa: E402

from test_torch_campaign_scripts import SCRIPTS, SMALL, _script  # noqa: E402

TWINS = ("torch_trace_summary", "torch_profile_rollout", "torch_profile_closed_loop",
         "torch_profile_seq2seq", "torch_bench_cell", "torch_bench_ncread",
         "profile_torch_train_step")
ROLLOUT_ROWS = ("full_hoist", "full_scan", "cells_taps_hoist", "cells_taps_scan",
                "cells_notaps_hoist", "cells_notaps_hoist_L1", "cells_notaps_hoist_L2")
SUMMARY_KEYS = ("label", "config", "steps", "trace", "device_total_ms", "device_ms_per_step",
                "cell_kernel_ms", "b1_ms", "b2a_ms", "dw_ms", "b3_ms", "conv_op_ms",
                "analytic_gflops_per_step", "sustained_tflops", "fraction_of_bf16_peak",
                "top_ops_ms", "launches", "b1_layers")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _finite(obj) -> bool:
    """Every number in a JSON-like object is finite."""
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def _jax_trace_summary():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_summary", os.path.join(SCRIPTS, "trace_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- trace summary

@pytest.mark.parametrize("config", ["northstar", "closedloop6"])
def test_analytic_flops_equal_the_jax_scripts(config):
    ts = _script("torch_trace_summary")
    want = _jax_trace_summary().conv_gflops_per_step(154, config)
    got = ts.conv_gflops_per_step(154, config)
    assert abs(got - want) <= 1e-12 * want, (got, want)


def test_training_flops_are_the_gate_convs_of_every_frame():
    """Forward: B*T frames of the config's three gate convs (no head);
    forward + backward without the recompute: three times that."""
    ts = _script("torch_trace_summary")
    fwd, fwd_bwd = ts.train_gflops_per_step("closedloop6", 8, 48, 154)
    head = 2 * 16 * 100 * 154 / 1e9
    assert fwd == pytest.approx(8 * 48 * (ts.conv_gflops_per_step(154, "closedloop6") - head),
                                rel=1e-12)
    assert fwd_bwd == pytest.approx(3 * fwd, rel=1e-12)


B1_NAME = ("void niswan::cell_wgmma_kernel<5, 8, (anonymous namespace)::CellEpi<__nv_bfloat16> "
           ">(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, (anonymous namespace)::"
           "CellEpi<__nv_bfloat16>, int, int, int)")
B2A_NAME = B1_NAME.replace("CellEpi", "BackwardEpi")
FP32_NAME = ("void niswan::cell_fp32_kernel<float, 3, (anonymous namespace)::CellEpi<float> >"
             "(float const*, float const*, float const*, (anonymous namespace)::CellEpi<float>, "
             "int, int, int, int, int)")
DW_NAME = "void (anonymous namespace)::dw_mma_kernel<5, 4>(__nv_bfloat16 const*, int)"
SUM_NAME = "void (anonymous namespace)::sum_rows_kernel(float const*, float*, long long, int)"
B3_NAME = "void (anonymous namespace)::conv_same_fp32_kernel<float, 3>(float const*, int)"
CUDNN_NAME = "nvjet_tst_192x8_64x8_4x1_v_bz_TNT"  # cuBLAS
ELEM_NAME = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >"


def _kernel(name, ts, dur, stream):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "args": {"stream": stream}}


HAND_EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
    _kernel(B1_NAME, 0, 10, 7),
    _kernel(B2A_NAME, 5, 10, 8),  # overlaps B1 on another stream: [0, 15] once
    _kernel(FP32_NAME, 20, 4, 7),
    _kernel(DW_NAME, 30, 6, 7),
    _kernel(SUM_NAME, 36, 1, 7),  # touches the dW launch: [30, 37]
    _kernel(B3_NAME, 40, 2, 7),
    _kernel(CUDNN_NAME, 50, 3, 7),
    _kernel(ELEM_NAME, 60, 1, 7),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7, "ts": 70,
     "dur": 5},
]


def test_hand_made_trace_union_split_and_top_ops():
    ts = _script("torch_trace_summary")
    s = ts.summarize(HAND_EVENTS, steps=2, label="hand", card="test card")
    assert s["kernel_events"] == 8
    assert s["device_total_ms"] == 0.032  # 15 + 4 + 7 + 2 + 3 + 1 us
    assert s["device_ms_per_step"] == 0.016
    assert s["device_span_ms"] == 0.061 and s["device_idle_frac"] == 1 - 32 / 61
    assert s["largest_gap_ms"] == 0.008 and s["memcpy_ms"] == 0.005  # [42, 50]; the copy
    assert (s["b1_ms"], s["b2a_ms"], s["dw_ms"], s["b3_ms"]) == (0.014, 0.01, 0.007, 0.002)
    assert (s["conv_op_ms"], s["other_ms"], s["cell_pack_ms"]) == (0.003, 0.001, 0.0)
    assert s["cell_kernel_ms"] == s["b1_ms"] + s["b2a_ms"]
    assert s["launches"] == {"b1": 2, "b2a": 1, "cell_pack": 0, "dw": 2, "b3": 1,
                             "conv_op": 1, "other": 1}
    want_top = {B1_NAME[:80]: 0.01, B2A_NAME[:80]: 0.01, DW_NAME[:80]: 0.006,
                FP32_NAME[:80]: 0.004, CUDNN_NAME[:80]: 0.003, B3_NAME[:80]: 0.002,
                SUM_NAME[:80]: 0.001, ELEM_NAME[:80]: 0.001}
    assert s["top_ops_ms"] == want_top
    layer, = s["b1_layers"]  # the f32 kernel names no hidden size
    assert (layer["k"], layer["hid"], layer["launches"], layer["ms_per_launch"]) == \
        (5, 64, 1, 0.01)
    assert layer["bound_ms"] == ts.cell_bound_ms(1, 154, 126, 64, 5)
    gflops = ts.conv_gflops_per_step(154, "northstar")
    assert s["analytic_gflops_per_step"] == gflops
    assert s["sustained_tflops"] == gflops / 0.016
    assert s["fraction_of_bf16_peak"] == gflops / 0.016 / 989.0
    assert s["card"] == "test card"


def test_a_cell_kernel_without_its_epilogue_in_the_name_raises():
    ts = _script("torch_trace_summary")
    name = "void niswan::cell_wgmma_kernel<5, 8, Epi>(int)"
    with pytest.raises(ValueError, match="epilogue"):
        ts.summarize([_kernel(name, 0, 1, 7)], steps=1, label="x")


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 4), (1, 2), (3, 6)], 6.0),  # nested and overlapping
    ([(5, 7), (0, 1), (1, 2)], 4.0),  # unsorted, touching
])
def test_interval_union(intervals, want):
    assert _script("torch_trace_summary").union_us(intervals) == want


def test_real_cpu_trace_and_the_cli(tmp_path):
    """A trace written by utils/profiling.trace on the CPU has no kernel
    events: zero device time and no rate.  The CLI reads the directory and
    the gzipped file alike and writes --out."""
    ts = _script("torch_trace_summary")
    with trace(str(tmp_path / "tr")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    s = ts.summarize_file(str(tmp_path / "tr"), steps=4, label="cpu")
    assert s["kernel_events"] == 0 and s["device_total_ms"] == 0.0
    assert s["device_span_ms"] == 0.0 and s["device_idle_frac"] is None
    assert s["sustained_tflops"] is None and s["fraction_of_bf16_peak"] is None
    assert all(n == 0 for n in s["launches"].values())
    gz = tmp_path / "trace.json.gz"
    with open(tmp_path / "tr" / "trace.json", "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    out = tmp_path / "summary.json"
    got = ts.main([str(gz), "--steps", "4", "--label", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == got
    assert all(k in got for k in SUMMARY_KEYS)
    assert {k: v for k, v in got.items() if k != "trace"} == \
        {k: v for k, v in s.items() if k != "trace"}


# ---------------------------------------------------------------- serving profiles

def test_profile_rollout_rows_trace_and_summary(tmp_path):
    mod = _script("torch_profile_rollout", C=5, **SMALL)
    res = mod.main(["--device", "cpu", "--steps", "4", "--reps", "1", "--trace",
                    str(tmp_path / "tr"), "--trace-steps", "2", "--summary",
                    str(tmp_path / "s.json"), "--out", str(tmp_path / "r.json")])
    assert tuple(res["ms_per_step"]) == ROLLOUT_ROWS
    assert all(v > 0 and math.isfinite(v) for v in res["ms_per_step"].values())
    # no device time on the CPU
    assert all(v is None for k in ("span_ms_per_step", "device_ms_per_step")
               for v in res[k].values())
    assert (res["impl"], res["batch"], res["card"]) == ("kernel", 1, "cpu")
    with open(tmp_path / "s.json") as f:
        assert json.load(f) == res["summary"]
    assert res["summary"]["steps"] == 2 and res["summary"]["kernel_events"] == 0
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == res


def test_profile_rollout_cells_rows_run_the_model():
    """The cells rows' runner on prepared frames gives convlstm_apply's
    prediction (and taps) on the CPU."""
    mod = _script("torch_profile_rollout", **SMALL)
    from nasa_niswan_tpu_torch.models.convlstm import (ConvLSTMConfig, convlstm_apply,
                                                       convlstm_init)

    cfg = ConvLSTMConfig(in_channels=3, hidden_channels=mod.HIDDEN,
                         kernel_sizes=mod.KERNELS)
    params = convlstm_init(torch.Generator().manual_seed(0), cfg)
    xs = torch.randn((1, 3, *mod.PADDED, 3), generator=torch.Generator().manual_seed(1))
    for taps in (False, True):
        got = mod.cells_fn(cfg, taps, True, mod.CELL_FNS["kernel"])(params, xs)
        with torch.no_grad():
            want = convlstm_apply(params, xs, cfg, return_per_step=taps,
                                  precompute_input_conv=True)
        want = want if taps else (want,)
        assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in zip(got, want))


def test_profile_closed_loop_chain_trace_and_summary(tmp_path):
    mod = _script("torch_profile_closed_loop", **SMALL)
    res = mod.main(["--device", "cpu", "--steps", "3", "--chain", "2", "--trace",
                    str(tmp_path / "tr"), "--summary", str(tmp_path / "s.json")])
    assert (res["impl"], res["chain"], res["steps"]) == ("kernel", 2, 3)
    assert res["ms_per_step"] > 0 and res["model_days_per_min"] > 0 and _finite(res)
    assert res["summary"]["config"] == "closedloop6" and res["summary"]["steps"] == 3


# ---------------------------------------------------------------- seq2seq profile

S2S_KEYS = ("B", "T", "step_s", "step_fused_s", "step_zero_pad_s", "pad_share",
            "ms_per_scan_step", "ms_per_scan_step_fused", "speedup_vs_per_cell",
            "step_fused_zero_pad_s", "pad_share_fused")


def test_profile_seq2seq_keys(tmp_path):
    mod = _script("torch_profile_seq2seq", **SMALL)
    res = mod.main(["--device", "cpu", "--T", "3", "--batch", "2", "--reps", "1",
                    "--out", str(tmp_path / "r.json")])
    assert all(k in res for k in S2S_KEYS) and _finite(res)
    assert (res["B"], res["T"]) == (2, 3)
    assert all(res[k] > 0 for k in S2S_KEYS if k.endswith("_s"))
    assert seq2seq_bptt.fb_channel is not mod.zero_fb_channel


def test_zero_pad_has_fb_channels_shape_and_the_map():
    mod = _script("torch_profile_seq2seq", **SMALL)
    fb = torch.randn((2, *mod.GRID))
    real, zero = seq2seq_bptt.fb_channel(fb, mod.PADDED), mod.zero_fb_channel(fb, mod.PADDED)
    assert zero.shape == real.shape == (2, *mod.PADDED, 1)
    h, w = mod.GRID
    assert torch.equal(zero[:, :h, :w, 0], fb)
    assert not zero[:, h:].any() and not zero[:, :, w:].any()
    assert torch.equal(real[..., 0], pad_geo(fb, mod.PADDED))


def test_pad_ablation_restores_fb_channel_when_the_step_raises():
    """The swap is undone on the way out of a step that raises: here a
    train step fed a batch of the wrong shape."""
    mod = _script("torch_profile_seq2seq", **SMALL)
    from nasa_niswan_tpu_torch.data.dataset import Normalizer
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.seq2seq import make_seq2seq_train_step
    from nasa_niswan_tpu_torch.train.loop import make_optimizer

    real = seq2seq_bptt.fb_channel
    cfg = ConvLSTMConfig(in_channels=6, hidden_channels=mod.HIDDEN, kernel_sizes=mod.KERNELS)
    params = convlstm_init(torch.Generator().manual_seed(0), cfg)
    for t in (t for c in params["cells"] for t in c.values()):
        t.requires_grad_(True)
    norm = Normalizer(np.zeros(5, np.float32), np.ones(5, np.float32), 0.0, 1.0)
    step = make_seq2seq_train_step(cfg, norm, make_optimizer(params, 1e-3, (0.5, 0.999)),
                                   padded_shape=mod.PADDED, grid_shape=mod.GRID)
    x = torch.zeros((1, 2, 5, *mod.GRID))
    with pytest.raises(RuntimeError):
        with mod.zero_pad_feedback():
            assert seq2seq_bptt.fb_channel is mod.zero_fb_channel
            step(params, x, torch.zeros((1, *mod.GRID)), torch.zeros((1, 2, 5, 5)),
                 torch.Generator().manual_seed(1), 0.8)
    assert seq2seq_bptt.fb_channel is real


# ---------------------------------------------------------------- cell shootout

def test_bench_cell_serving_rows_and_parity(tmp_path):
    mod = _script("torch_bench_cell", C=5, **SMALL)
    res = mod.main(["--device", "cpu", "--steps", "4", "--reps", "1", "--parity",
                    "--out", str(tmp_path / "r.json")])
    par, *rows = res["rows"]
    assert par["steps"] == 4 and 0 <= par["max_rel_pred"] < mod.PARITY_REL
    # on the CPU the kernel cell is the plain version: the same maps
    assert par["max_abs_pred"] == 0.0 and par["max_abs_h"] == 0.0
    assert [r["impl"] for r in rows] == ["kernel:hoist", "kernel:scan", "plain:scan"]
    for r in rows:
        assert set(r) == {"impl", "ms_per_step", "days_per_min", "last_map_mean"}
        assert r["ms_per_step"] > 0 and _finite(r)
    assert rows[1]["last_map_mean"] == rows[2]["last_map_mean"]


def test_bench_cell_train_rows():
    mod = _script("torch_bench_cell", TRAIN_T=3, **SMALL)
    res = mod.main(["--device", "cpu", "--train", "--train-batches", "2", "--train-steps",
                    "1"])
    row, = res["rows"]
    assert set(row) == {"train_batch", "loss_per_cell", "ms_per_cell", "loss_remat",
                        "ms_remat", "speedup_remat"}
    assert row["train_batch"] == 2 and _finite(row) and row["ms_remat"] > 0
    # the two routes take the same first step from the same weights and batch
    assert row["loss_per_cell"] == pytest.approx(row["loss_remat"], rel=1e-4)


@pytest.mark.parametrize("spec", ["xla:scan", "pallas2:hoist", "kernel:unroll"])
def test_bench_cell_refuses_other_cells(spec):
    mod = _script("torch_bench_cell", **SMALL)
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", "--impls", spec])


# ---------------------------------------------------------------- netCDF read bench

def test_bench_ncread_keys_and_equal_arrays(tmp_path):
    mod = _script("torch_bench_ncread", STEPS_PER_DAY=4, GRID=(6, 8), LEVELS=3, REPS=1,
                  SAMPLES=4)
    res = mod.main(["--out", str(tmp_path / "r.json")])
    keys = ("day_files", "total_MB", "scipy_ms", "native_ms", "speedup", "native_GBps",
            "day_fields_scipy_ms", "day_fields_native_ms", "day_fields_speedup",
            "netcdf3_open_ms", "netcdf3_lazy_samples_per_s", "cdf5_open_ms",
            "cdf5_lazy_samples_per_s", "netcdf4_open_ms", "netcdf4_lazy_samples_per_s")
    assert all(k in res for k in keys) and _finite(res)
    assert res["native_equals_scipy"] is True and res["day_files"] == 5
    assert os.environ.get("NISWAN_NO_NATIVE_NC") is None


def test_native_reader_gives_scipys_arrays(tmp_path):
    mod = _script("torch_bench_ncread", STEPS_PER_DAY=4, GRID=(6, 8), LEVELS=3)
    from nasa_niswan_tpu_torch.data import ncio
    from nasa_niswan_tpu_torch.data.ncio_native import open_nc_native

    paths = mod.day_files(str(tmp_path), days=1)
    assert mod.same_arrays(paths)
    for p in paths:
        a, b = open_nc_native(p), ncio._open_scipy(p)
        for n in b.variables:
            np.testing.assert_array_equal(a[n], b[n])


# ---------------------------------------------------------------- training profile

def test_profile_train_step_table_and_summary(tmp_path):
    mod = _script("profile_torch_train_step", BS=2, SEQ=4, DATA_T=60, **SMALL)
    res = mod.main(["--device", "cpu", "--routes", "remat", "per-cell", "seq2seq",
                    "--route", "seq2seq-remat", "--reps", "1", "--steps", "1",
                    "--out", str(tmp_path / "r.json")])
    for route in ("remat", "per-cell", "seq2seq"):
        assert set(res[route]) == {"step_ms", "days_per_min"} and res[route]["step_ms"] > 0
        assert res[route]["days_per_min"] == pytest.approx(
            (2 * 4 / 48) / (res[route]["step_ms"] / 6e4), rel=1e-12)
    assert "seq2seq-remat" not in res  # profiled, not in the table
    prof = res["profile"]
    assert prof["route"] == "seq2seq-remat" and prof["wall_ms"] > 0
    s = prof["summary"]
    fwd, fwd_bwd = _script("torch_trace_summary").train_gflops_per_step("closedloop6", 2, 4, 28)
    assert s["analytic_gflops_per_step"] == fwd_bwd and s["forward_gflops_per_step"] == fwd
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == res


# ---------------------------------------------------------------- imports, devices

@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_jax_package(name):
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    bad = {m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nasa_niswan_tpu")}
    assert not bad, bad


@pytest.mark.parametrize("name, argv", [
    ("torch_profile_rollout", ["--steps", "2"]),
    ("torch_profile_closed_loop", ["--steps", "2"]),
    ("torch_profile_seq2seq", ["--T", "2"]),
    ("torch_bench_cell", ["--steps", "2"]),
    ("profile_torch_train_step", ["--routes", "remat"]),
])
def test_twin_asked_for_the_card_without_one_raises(name, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _script(name, **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)  # --device defaults to cuda
