"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers), so one nvcc call
builds them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/libniswan_kernels_<hash>.so csrc/*.cu

The library lands in ``build/kernels/`` beside the package (listed in
.gitignore) at first use, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads as it is.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
beside it as ``.log``.  Nothing is built when a module is imported, and a
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        f"nvcc not found ($CUDA_HOME/bin, $PATH, {DEFAULT_CUDA_HOME}/bin): the "
        "CUDA kernels of nasa_niswan_tpu_torch need the CUDA toolkit"
    )


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC_DIR.glob("*.cu")))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libniswan_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's types."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("niswan_convlstm_cell_f32", "niswan_convlstm_cell_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.niswan_error_string.argtypes = [i32]
    lib.niswan_error_string.restype = ctypes.c_char_p
    return lib
