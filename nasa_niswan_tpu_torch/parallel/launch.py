"""Start the ranks of a mesh (no counterpart module: in JAX one process
holds every device).

``spawn(fn, world_size, device_type, *args)`` runs ``fn(rank, *args)`` in
``world_size`` fresh processes (the ``spawn`` start method), each joined to
one process group through a ``file://`` store in a new temporary directory,
so that concurrent worlds share no port.  Rank r runs on ``cuda:r`` or the
CPU (one torch thread per CPU rank: the ranks share the host's cores).  On
cuda it raises unless there is a card for every rank: NCCL refuses two
ranks on one card, and nothing drops to gloo or to the CPU.  A rank that
raises makes ``spawn`` raise with its traceback; the other ranks, which
may wait on it in a collective, are killed.  ``fn`` is sent by module and
name, so it must be a module-level function (one of a module run with
``python -m`` is found under that module's name).

Under torchrun (``WORLD_SIZE`` set in the environment) the ranks already
exist: ``spawn`` joins this process to their group and runs ``fn`` here.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Tuple

import torch


def _target(fn: Callable) -> Tuple[str, str]:
    module = fn.__module__
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    if module == "__main__" and spec is not None:
        # ``python -m pkg.mod``: the spawned process does not rerun the
        # module as its __main__, so import it by name (a script run by
        # path is rerun there, and found as __main__)
        module = spec.name
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not a module-level function")
    return module, fn.__qualname__


def _entry(target, rank: int, world_size: int, device_type: str, init_method: str,
           out_dir: str, args) -> None:
    from nasa_niswan_tpu_torch.parallel.mesh import init_distributed

    import torch.distributed as dist

    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        init_distributed(init_method, world_size, rank, device_type=device_type)
        fn = getattr(importlib.import_module(target[0]), target[1])
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"result-{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def check_devices(world_size: int, device_type: str) -> None:
    """Raise unless every rank can have a device of its own.  Under
    torchrun (``WORLD_SIZE`` set) the ranks of this host,
    ``LOCAL_WORLD_SIZE``, need this host's cards, and this rank's card
    (``cuda:LOCAL_RANK``, as ``mesh.rank_device`` picks it) must be one of
    them; otherwise all ``world_size`` ranks run here."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need, where = world_size, ""
        if os.environ.get("WORLD_SIZE"):
            card = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
            need = max(int(os.environ.get("LOCAL_WORLD_SIZE", 0)), card + 1)
            where = " on this host"
        if n < need:
            raise RuntimeError(
                f"{need} ranks{where} need {need} CUDA devices, {n} visible: "
                "NCCL takes one card per rank")
    elif device_type != "cpu":
        raise ValueError(f"device_type must be cuda or cpu, got {device_type!r}")


def spawn(fn: Callable, world_size: int, device_type: str, *args,
          timeout: Optional[float] = None) -> List:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks; returns the ranks'
    return values in rank order (under torchrun: this rank's value at its
    index, None elsewhere).  ``timeout`` (seconds) bounds the whole run."""
    check_devices(world_size, device_type)
    if os.environ.get("WORLD_SIZE"):
        from nasa_niswan_tpu_torch.parallel.mesh import init_distributed

        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} ranks, "
                             f"{world_size} asked for")
        rank = init_distributed(device_type=device_type)
        out = [None] * world_size
        out[rank] = fn(rank, *args)
        return out

    target = _target(fn)
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="niswan-spawn-")
    init_method = "file://" + os.path.join(out_dir, "store")
    procs = [
        ctx.Process(target=_entry, name=f"rank-{r}", daemon=False,
                    args=(target, r, world_size, device_type, init_method, out_dir, args))
        for r in range(world_size)
    ]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                errors = []
                for r in failed:
                    path = os.path.join(out_dir, f"error-{r}.txt")
                    text = open(path).read() if os.path.exists(path) else \
                        f"exit code {codes[r]}\n"
                    errors.append(f"rank {r}:\n{text}")
                raise RuntimeError("spawned rank failed\n" + "\n".join(errors))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawned ranks still running after {timeout} s")
            procs[codes.index(None)].join(0.05)
        return [torch.load(os.path.join(out_dir, f"result-{r}.pt"), map_location="cpu",
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
