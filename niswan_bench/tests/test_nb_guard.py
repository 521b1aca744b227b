"""The import guard compares top-level module names whole, the harness and
its reference import neither JAX nor the JAX package, and the reference
imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from niswan_bench.lib import guard, spec


@pytest.mark.parametrize("names,found", [
    (["nasa_niswan_tpu_torch", "nasa_niswan_tpu_torch.ops.convgrad", "numpy"], []),
    (["nasa_niswan_tpu", "numpy"], ["nasa_niswan_tpu"]),
    (["nasa_niswan_tpu.models.convlstm"], ["nasa_niswan_tpu"]),
    (["jaxlib.xla_client", "jax_like", "jaxtyping"], ["jaxlib"]),
    (["jax", "flax.linen"], ["flax", "jax"]),
])
def test_top_level_names_compared_whole(names, found):
    assert guard.forbidden_loaded(names) == found


def test_check_raises_naming_what_it_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "nasa_niswan_tpu.fake", object())
    with pytest.raises(guard.ForbiddenImport, match="nasa_niswan_tpu"):
        guard.check("in a test")


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(spec.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not guard.forbidden_loaded(list(imports(path))), path


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_torch_and_numpy_only(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert tops <= {"__future__", "contextlib", "typing", "numpy", "torch", "math"}, tops


def test_a_loaded_harness_holds_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from niswan_bench import run\n"
        "from niswan_bench.lib import guard, spec\n"
        "bench = spec.benchmark()\n"
        "for w in bench['workloads']:\n"
        "    spec.runner(spec.traffic(w['traffic'])['runner'])\n"
        "for m in bench['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "print(guard.forbidden_loaded())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
