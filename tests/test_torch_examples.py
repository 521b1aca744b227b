"""The port's examples (examples/torch_quickstart.py, examples/torch_serving.py)
run end to end on the CPU (``--device cpu``) at their own CPU sizes.

The quickstart writes its configuration, its checkpoint, the test results in
the reference layout and its two figures (matplotlib is present here); with
``--no-figures`` it draws none, and without that flag and without
matplotlib it fails rather than skip them.  The serving example's chunks,
served by the exported ``.pt2`` program with the carry handed from chunk to
chunk, equal ``make_rollout_fn`` run over the same frames in one call to
1e-6 of the largest prediction (the same body, one chunk boundary apart)."""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nasa_niswan_tpu_torch.evalx.evaluate import load_test_results  # noqa: E402
from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn  # noqa: E402
from nasa_niswan_tpu_torch.rollout.export import load_rollout_info  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TINY = ["--grid", "8", "12", "--steps", "60", "--epochs", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    out = tmp_path_factory.mktemp("quickstart")
    return out, _example("torch_quickstart").main(["--device", "cpu", "--outdir", str(out)])


def test_quickstart_writes_checkpoint_results_and_figures(quickstart):
    out, _ = quickstart
    assert os.path.isfile(out / "configurations.json")
    assert os.path.isfile(out / "epoch-005" / "checkpoint.npz")
    assert os.path.isfile(out / "logger.npy")
    gts, pds = load_test_results(str(out / "test-results.npy"))
    assert gts.shape == pds.shape and gts.shape[1:] == (24, 36)
    assert np.isfinite(pds).all()
    for png in ("spatial_r2.png", "qq.png"):
        with open(out / png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_quickstart_reports_skill_and_sensitivity(quickstart):
    _, result = quickstart
    summary = result["report"]["temporal_r2_summary"]
    assert all(math.isfinite(v) for v in summary.values())
    assert list(result["sensitivity"]) == ["u", "v", "w", "prec", "src"]
    assert all(math.isfinite(v) and v >= 0 for v in result["sensitivity"].values())
    assert len(result["logger"]["MSELoss"]) == 5


@pytest.mark.parametrize("flags, drawn", [([], False), (["--no-figures"], True)],
                         ids=["figures", "no-figures"])
def test_quickstart_without_matplotlib(flags, drawn, tmp_path, monkeypatch):
    """Without matplotlib the figures fail the run (ImportError naming
    matplotlib) unless --no-figures skips them."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--device", "cpu", "--outdir", str(tmp_path), *TINY, *flags]
    if drawn:
        _example("torch_quickstart").main(argv)
        assert os.path.isfile(tmp_path / "test-results.npy")
    else:
        with pytest.raises(ImportError, match="matplotlib"):
            _example("torch_quickstart").main(argv)
    assert not os.path.exists(tmp_path / "spatial_r2.png")


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    out = tmp_path_factory.mktemp("serving")
    return out, _example("torch_serving").main(["--device", "cpu", "--outdir", str(out)])


def test_serving_writes_the_artifact(serving):
    out, result = serving
    assert result["artifact"] == str(out / "emulator.pt2")
    _, shape = load_rollout_info(result["artifact"], device="cpu")
    assert shape == (1, 8, 5, 24, 36)
    assert os.path.isfile(out / "run" / "epoch-003" / "checkpoint.npz")


def test_served_chunks_equal_one_rollout(serving):
    _, r = serving
    served = r["preds"]
    assert served.shape == (r["frames"].shape[0], 24, 36) and served.shape[0] % 8 == 0
    rollout = make_rollout_fn(r["config"], r["normalizer"], padded_shape=r["padded"],
                              grid_shape=(24, 36))
    want, _ = rollout(r["params"], r["frames"][None])
    want = want[0].numpy()
    assert np.abs(served - want).max() <= 1e-6 * np.abs(want).max()
