"""The port's surface held to the JAX package's, by ``ast`` alone (neither
package is imported, so the file costs milliseconds).

* Every module of ``nasa_niswan_tpu/`` has a file of the same path in
  ``nasa_niswan_tpu_torch/``, or an entry in ``TPU_ONLY_MODULES`` with its
  reason.
* Every public top-level name of each such JAX module (a ``def``, a
  ``class``, an assignment, or an entry of ``__all__``, at the module's
  own level: not an optional import's ``try`` or the ``__main__`` block)
  is defined, imported or listed in ``__all__`` by the port's module, or
  has an entry in ``TPU_ONLY_NAMES`` with its reason.
* Every ``add_argument`` flag of the JAX command lines (the train, serving
  and evaluation CLIs, and each ``scripts/X.py`` that has a
  ``scripts/torch_X.py``) is accepted by the port's, or has an entry in
  ``FLAG_MAP`` naming the port's flag and the reason.
* An entry whose JAX name no longer exists, or that the port now has
  under the JAX name, fails, so the maps cannot go stale.

One test per JAX module and per command-line pair, three for the maps and
three for the checker itself."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "nasa_niswan_tpu")
PORT_PKG = os.path.join(ROOT, "nasa_niswan_tpu_torch")

# JAX module -> (the port's module that does its work, or None; why there
# is no file of the same path)
TPU_ONLY_MODULES = {
    "ops/convlstm_pallas.py": (
        "ops/convlstm_cell.py",
        "Pallas TPU kernel (B4, the v1 cell): its math is B1's plain mode plus "
        "cell_grads, in the CUDA kernel module"),
    "ops/convlstm_pallas2.py": (
        "ops/convlstm_cell.py",
        "Pallas TPU kernel (B1, the fused cell forward): csrc/convlstm_cell.cu "
        "behind ops/convlstm_cell.py"),
    "ops/convgrad_pallas.py": (
        "ops/convgrad.py",
        "Pallas TPU kernels (B2 the cell backward, B3 the SAME conv): "
        "csrc/cell_bwd.cu and csrc/conv_same.cu behind ops/convgrad.py"),
    "ops/vma.py": (
        None,
        "shard_map's varying-manual-axes typing; the port shards by rank, "
        "with no shard_map"),
    "train/checkpoint_orbax.py": (
        "train/checkpoint_async.py",
        "orbax imports JAX; the asynchronous backend keeps its contract in the "
        "npz layout"),
    "utils/cache.py": (
        None,
        "XLA's persistent compilation cache; the port builds its kernels once "
        "per checkout"),
}

_AUTO = "the north star's TPU auto policy; the port runs its kernels on a CUDA tensor"
_GSPMD = "GSPMD sharding; the port dispatches by device and shards by rank"
# (JAX module, public name) -> why the port has no such name
TPU_ONLY_NAMES = {
    ("models/convlstm.py", "resolve_auto_impl"): _AUTO,
    ("models/convlstm.py", "resolve_bptt_fwd"): _AUTO,
    ("rollout/autoregressive.py", "resolve_cell_impl"): _AUTO,
    ("data/pipeline.py", "device_prefetch"):
        "async_batches stages each batch on the device itself",
    ("parallel/dp.py", "gspmd_safe_bundle"): _GSPMD,
    ("parallel/dp.py", "dp_shardings"): _GSPMD,
    ("parallel/dp.py", "make_dp_train_step"):
        _GSPMD + ": train/loop.build_train_step_fn(mesh=)",
    ("parallel/dp.py", "make_dp_train_step_shardmap"):
        _GSPMD + ": train/loop.build_train_step_fn(mesh=)",
    ("parallel/dp.py", "make_dp_eval_step"):
        _GSPMD + ": train/loop.build_eval_step_fn(mesh=)",
    ("rollout/seq2seq.py", "make_seq2seq_train_step_shardmap"):
        _GSPMD + ": rollout/seq2seq.make_seq2seq_train_step(mesh=)",
    ("parallel/mesh.py", "batch_sharded"): _GSPMD,
    ("parallel/mesh.py", "replicated"): _GSPMD,
    ("parallel/mesh.py", "spatial_sharded"): _GSPMD,
    ("ops/convlstm_bptt.py", "scan_cells_pallas2"):
        "the custom_vjp over the Pallas kernels: ops/convlstm_bptt.scan_cells",
    ("ops/seq2seq_bptt.py", "scan_seq2seq_pallas2"):
        "the custom_vjp over the Pallas kernels: ops/seq2seq_bptt.scan_seq2seq",
    ("ops/seq2seq_bptt.py", "wp_of"):
        "the Pallas kernels' padded-column width; the port keeps no margin layout",
}

# (JAX command line, JAX flag) -> (the port's flag, why it is renamed)
FLAG_MAP = {
    ("scripts/run_train_year.py", "--platform"):
        ("--device", "a JAX platform name; the port takes a torch device"),
    ("scripts/bench_sharded_rollout.py", "--impls"):
        ("--cells", "JAX's cell implementations; the port compares its plain cell "
                    "with the kernel"),
    ("scripts/multihost_worker.py", "--process-id"):
        ("--rank", "one process per card: the process is the rank"),
    ("scripts/multihost_worker.py", "--num-processes"):
        ("--world-size", "one process per card: the processes are the world"),
    ("scripts/multihost_worker.py", "--local-devices"):
        ("--world-size", "a JAX process owns several devices; a port process owns "
                         "one card, so the world size counts the cards"),
}


def public_names(path: str, *, imports: bool) -> set:
    """Public names of a module's own level: defined (``def``, ``class``, an
    assignment) or listed in ``__all__``; with ``imports``, imported too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                names |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                names |= {e.value for e in node.value.elts}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def cli_flags(path: str) -> set:
    """The option strings of every ``add_argument`` call in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)
            and a.value.startswith("-")}


def modules(pkg: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, "/")
                  for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))


def missing_module(rel: str, port_pkg=PORT_PKG, tpu_only=TPU_ONLY_MODULES) -> bool:
    return not os.path.isfile(os.path.join(port_pkg, rel)) and rel not in tpu_only


def missing_names(rel: str, jax_pkg=JAX_PKG, port_pkg=PORT_PKG,
                  tpu_only=TPU_ONLY_NAMES) -> list:
    want = public_names(os.path.join(jax_pkg, rel), imports=False)
    have = public_names(os.path.join(port_pkg, rel), imports=True)
    return sorted(n for n in want - have if (rel, n) not in tpu_only)


def missing_flags(jax_cli: str, port_cli: str, root=ROOT, flag_map=FLAG_MAP) -> list:
    want = cli_flags(os.path.join(root, jax_cli))
    have = cli_flags(os.path.join(root, port_cli))
    return sorted(f for f in want - have if (jax_cli, f) not in flag_map)


def cli_pairs(root=ROOT) -> list:
    pairs = [(f"nasa_niswan_tpu/{m}", f"nasa_niswan_tpu_torch/{m}")
             for m in ("train/config.py", "rollout/__main__.py", "evalx/__main__.py")]
    scripts = os.path.join(root, "scripts")
    pairs += [(f"scripts/{f}", f"scripts/torch_{f}") for f in sorted(os.listdir(scripts))
              if f.endswith(".py") and not f.startswith("torch_")
              and os.path.isfile(os.path.join(scripts, f"torch_{f}"))]
    return pairs


JAX_MODULES = modules(JAX_PKG)
PORTED = [m for m in JAX_MODULES if m not in TPU_ONLY_MODULES]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(rel):
    assert not missing_module(rel), f"nasa_niswan_tpu/{rel}: no port module, no reason"


@pytest.mark.parametrize("rel", PORTED)
def test_every_public_name_has_a_counterpart(rel):
    missing = missing_names(rel)
    assert not missing, f"nasa_niswan_tpu/{rel}: {missing} not in the port's module"


@pytest.mark.parametrize("jax_cli,port_cli", cli_pairs())
def test_every_jax_flag_is_accepted_by_the_port(jax_cli, port_cli):
    missing = missing_flags(jax_cli, port_cli)
    assert not missing, f"{jax_cli}: {missing} not accepted by {port_cli}"


def test_tpu_only_modules_are_current():
    for rel, (counterpart, reason) in TPU_ONLY_MODULES.items():
        assert reason
        assert os.path.isfile(os.path.join(JAX_PKG, rel)), f"stale entry: {rel}"
        assert not os.path.isfile(os.path.join(PORT_PKG, rel)), f"{rel} is ported now"
        assert counterpart is None or os.path.isfile(os.path.join(PORT_PKG, counterpart))


def test_tpu_only_names_are_current():
    for (rel, name), reason in TPU_ONLY_NAMES.items():
        assert reason
        assert name in public_names(os.path.join(JAX_PKG, rel), imports=False), (
            f"stale entry: {rel}::{name}")
        assert name not in public_names(os.path.join(PORT_PKG, rel), imports=True), (
            f"{rel}::{name} is ported now")


def test_flag_map_is_current():
    ports = dict(cli_pairs())
    for (jax_cli, flag), (port_flag, reason) in FLAG_MAP.items():
        assert reason and jax_cli in ports, f"stale entry: {jax_cli}"
        assert flag in cli_flags(os.path.join(ROOT, jax_cli)), f"stale entry: {flag}"
        port = cli_flags(os.path.join(ROOT, ports[jax_cli]))
        assert flag not in port, f"{jax_cli} {flag} is accepted by the port now"
        assert port_flag in port, f"{ports[jax_cli]} has no {port_flag}"


# ------------------------------------------------------- the checker itself

def _tree(root, files: dict):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def test_checker_finds_a_module_without_a_counterpart(tmp_path):
    _tree(tmp_path, {"j/a.py": "", "j/b.py": "", "t/a.py": ""})
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    assert [m for m in modules(j) if missing_module(m, t, {})] == ["b.py"]
    assert not [m for m in modules(j) if missing_module(m, t, {"b.py": (None, "x")})]


def test_checker_finds_a_name_without_a_counterpart(tmp_path):
    _tree(tmp_path, {
        "j/m.py": "import os\nA = 1\nB: int = 2\n_c = 3\ndef f(): pass\n"
                  "class K: pass\ndef g(): pass\n__all__ = ['h']\n"
                  "if __name__ == '__main__':\n    run = f()\n",
        "t/m.py": "from x import f\nA = 1\n__all__ = ['K', 'h']\n",
    })
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    assert missing_names("m.py", j, t, {}) == ["B", "g"]
    assert missing_names("m.py", j, t, {("m.py", "B"): "x", ("m.py", "g"): "y"}) == []


def test_checker_finds_a_flag_without_a_counterpart(tmp_path):
    _tree(tmp_path, {
        "j.py": "p.add_argument('--a', type=int)\np.add_argument('--b')\n"
                "p.add_argument('-c', '--cc')\n",
        "t.py": "p.add_argument('--a')\np.add_argument('--d')\n",
    })
    root = str(tmp_path)
    assert missing_flags("j.py", "t.py", root, {}) == ["--b", "--cc", "-c"]
    flag_map = {("j.py", f): ("--d", "x") for f in ("--b", "--cc", "-c")}
    assert missing_flags("j.py", "t.py", root, flag_map) == []
