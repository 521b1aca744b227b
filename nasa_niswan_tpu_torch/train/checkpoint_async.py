"""Asynchronous checkpoints with an atomic commit (counterpart of
nasa_niswan_tpu/train/checkpoint_orbax.py, the ``--checkpoint-backend
orbax`` of the training CLI).

The JAX package hands its saves to orbax's async CheckpointManager so that
frequent checkpoints (preemption coverage) do not stall the step loop.
orbax imports JAX and the port cannot read or write its files, so this
backend keeps its contract, not its format:

* ``save`` copies every tensor of the checkpoint to host memory (pinned,
  on a side stream, where the tensors are on the card; the current stream
  then waits for that copy, so the next Adam step cannot overwrite a
  parameter before it is read) and returns.  One background thread writes
  the files of ``train/checkpoint.save_checkpoint`` into a temporary
  directory and commits it by one rename to ``<directory>/epoch-NNN``, so
  a kill at any point leaves only committed checkpoints behind; it then
  deletes all but the newest ``max_to_keep``.
* ``restore_latest`` reads the newest committed one (``load_checkpoint``;
  each is also an ``epoch-NNN`` directory that either package loads).
* ``wait`` blocks until every save is committed, and raises what a write
  raised; ``close`` waits and stops the thread.

A directory that orbax wrote (integer step directories) is refused with a
message, not misread.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from nasa_niswan_tpu_torch.train.checkpoint import (
    _STATE_UNSET,
    CKPT_FILE,
    META_FILE,
    checkpoint_leaves,
    latest_epoch_dir,
    load_checkpoint,
    write_checkpoint,
)

_COMMITTED = re.compile(r"epoch-\d+$")
_TMP_PREFIX = ".tmp-"


def _host_copies(tensors: List[torch.Tensor]):
    """Host copies of ``tensors``: pinned and copied on a side stream for
    CUDA tensors (the current stream then waits for the copies), clones for
    CPU ones.  Returns (copies, the copies' CUDA event or None)."""
    event = None
    out: list = [None] * len(tensors)
    on_card = [i for i, t in enumerate(tensors) if t.is_cuda]
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            out[i] = t.detach().clone()
    if on_card:
        device = tensors[on_card[0]].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for i in on_card:
                t = tensors[i].detach()
                t.record_stream(side)  # a temporary (a zero moment) outlives no copy
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out[i] = host.copy_(t, non_blocking=True)
        event = side.record_event()
        current.wait_event(event)
    return out, event


class AsyncCheckpointer:
    """Checkpoints of (params, optimizer, model state) written by a
    background thread.

    >>> ckpt = AsyncCheckpointer(directory, max_to_keep=3)
    >>> ckpt.save(epoch, params, optimizer, learning_rate=lr)  # returns at once
    >>> params, opt_state, meta = ckpt.restore_latest(template)
    >>> ckpt.close()                                           # drains the saves
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if os.path.isdir(self.directory):
            steps = [d for d in os.listdir(self.directory) if d.isdigit()]
            if steps:
                raise ValueError(
                    f"{self.directory} holds orbax step directories ({', '.join(steps)}): "
                    "checkpoints of the JAX package's orbax backend, which this package "
                    "cannot read; restore them with the JAX package, or start from an "
                    "epoch-NNN checkpoint")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint")
        self._futures: List[concurrent.futures.Future] = []
        self._cleaned = False

    def save(self, step: int, params, optimizer: Optional[torch.optim.Optimizer] = None,
             *, learning_rate: Optional[float] = None, model_state=None) -> None:
        """Snapshot the checkpoint of epoch ``step`` to host memory and queue
        its write; returns before the files are committed."""
        self._raise_failed()
        leaves, meta = checkpoint_leaves(params, optimizer, learning_rate=learning_rate,
                                         epoch=step, model_state=model_state)
        names = [k for k, v in leaves.items() if isinstance(v, torch.Tensor)]
        copies, event = _host_copies([leaves[k] for k in names])
        leaves.update(zip(names, copies))
        self._futures.append(self._pool.submit(self._write, step, leaves, meta, event))

    def _write(self, step: int, leaves: dict, meta: dict, event) -> None:
        if event is not None:
            event.synchronize()
        os.makedirs(self.directory, exist_ok=True)
        if not self._cleaned:  # torn writes of a run that was killed
            for d in os.listdir(self.directory):
                if d.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
            self._cleaned = True
        name = f"epoch-{step:03d}"
        tmp = os.path.join(self.directory, _TMP_PREFIX + name)
        arrays = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                  for k, v in leaves.items()}
        write_checkpoint(tmp, arrays, meta)
        final = os.path.join(self.directory, name)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the commit
        for old in self.committed()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, old), ignore_errors=True)

    def committed(self) -> List[str]:
        """The committed checkpoints' directory names, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            d for d in os.listdir(self.directory)
            if _COMMITTED.match(d)
            and os.path.isfile(os.path.join(self.directory, d, META_FILE))
            and os.path.isfile(os.path.join(self.directory, d, CKPT_FILE)))

    def restore_latest(self, params_template, *, state_template=_STATE_UNSET):
        """``load_checkpoint`` of the newest committed checkpoint, or None if
        there is none: (params, opt_state, meta), or (params, opt_state,
        model_state, meta) with a ``state_template``."""
        latest = latest_epoch_dir(self.directory)
        if latest is None:
            return None
        return load_checkpoint(latest, params_template, state_template=state_template)

    def _raise_failed(self) -> None:
        for f in [f for f in self._futures if f.done()]:
            self._futures.remove(f)
            f.result()

    def wait(self) -> None:
        """Block until every queued save is committed; raises a write's
        error."""
        while self._futures:
            self._futures.pop(0).result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
