"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers).  Each ``.cu`` is
compiled by its own nvcc, all started together, then one nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o <obj> csrc/<source>.cu            (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/kernels/libniswan_kernels_<hash>.so <objs>

The library lands in ``build/kernels/`` beside the package (listed in
.gitignore) at first use, named by a hash of the sources, headers and flags,
so a changed source rebuilds and an unchanged one loads as it is.  nvcc's
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libniswan_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the output of the first
    that fails; return their joined output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{text}"
            )
    return "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.so.tmp")
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    try:
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's types (the
    span ``niswan.kernels.load``, its host seconds counted in
    ``utils/profiling.counters()["kernels.load_s"]``)."""
    # imported here: utils/profiling imports the models, which import this module
    from nasa_niswan_tpu_torch.utils.profiling import span

    with span("niswan.kernels.load", counter="kernels.load_s"):
        return _load(build())


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    part = [ptr, i32] + [i64] * 4  # (data, f32?, strides b, y, x, c)
    signatures = {
        # (xh, w, b, c, xg or null, h_out, c_out, gates or null,
        # packed w or null),
        # (B, H, W, Cin, hid, k), stream
        "niswan_convlstm_cell_f32": [ptr] * 9 + [i32] * 6 + [ptr],
        "niswan_convlstm_cell_bf16": [ptr] * 9 + [i32] * 6 + [ptr],
        # x part, h part, (b, c, h_out, c_out, packed w),
        # (B, H, W, Cx, hid, k), stream -> -1 where it does not take them
        "niswan_convlstm_cell_parts_bf16": part * 2 + [ptr] * 5 + [i32] * 6 + [ptr],
        # (xh, dgates, dw, work), (B, H, W, Cin, N, k), stream
        "niswan_conv_dw_f32": [ptr] * 4 + [i32] * 6 + [ptr],
        "niswan_conv_dw_bf16": [ptr] * 4 + [i32] * 6 + [ptr],
        # (xh, w, b, c, dh, dc, dgates, dc_prev, dw or null, db, work,
        # packed w or null), (B, H, W, Cin, hid, k), stream
        "niswan_cell_bwd_f32": [ptr] * 12 + [i32] * 6 + [ptr],
        "niswan_cell_bwd_bf16": [ptr] * 12 + [i32] * 6 + [ptr],
        # (w, packed w), (Cin, hid, k), stream
        "niswan_pack_cell_weights": [ptr] * 2 + [i32] * 3 + [ptr],
        # (x, w, out), (B, H, W, Cin, Cout, k), stream
        "niswan_conv_same_f32": [ptr] * 3 + [i32] * 6 + [ptr],
        "niswan_conv_same_bf16": [ptr] * 3 + [i32] * 6 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    # (bf16, xh, B, H, W, Cin, hid, k) -> floats of workspace, -1 if no
    # kernel takes them
    lib.niswan_cell_bwd_workspace.argtypes = [i32, ptr] + [i32] * 6
    lib.niswan_cell_bwd_workspace.restype = ctypes.c_longlong
    # (bf16, Cin, hid, k) -> floats of the packed weights (0: not packed,
    # -1: no kernel); (bf16, B, H, W, Cin, hid, k) -> the cell kernels'
    # mainloop: 1 wgmma, 0 FP32 pipes, -1 none
    lib.niswan_cell_pack_floats.argtypes = [i32] * 4
    lib.niswan_cell_pack_floats.restype = ctypes.c_longlong
    lib.niswan_cell_plan.argtypes = [i32] * 7
    lib.niswan_cell_plan.restype = i32
    # (bf16, xh, dgates, B, H, W, Cin, N, k) -> floats of workspace, -1 if
    # no kernel takes them
    lib.niswan_conv_dw_workspace.argtypes = [i32, ptr, ptr] + [i32] * 6
    lib.niswan_conv_dw_workspace.restype = ctypes.c_longlong
    # (bf16, B, H, W, Cin, N, k) -> 1 wgmma, 0 FP32 pipes, -1 none
    lib.niswan_conv_dw_plan.argtypes = [i32] * 7
    lib.niswan_conv_dw_plan.restype = i32
    lib.niswan_error_string.argtypes = [i32]
    lib.niswan_error_string.restype = ctypes.c_char_p
    return lib
