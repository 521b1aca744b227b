"""Array-backed datasets and normalization constants (counterpart of
nasa_niswan_tpu/data/dataset.py: ``DYNAMIC_CHANNELS``, ``Normalizer``,
``zscore_static``, ``masked_log10``, ``reference_splits``,
``SequenceDataset``, ``SingleStepDataset``, ``Seq2SeqDataset`` and
``make_preprocess_fn``).

The datasets are numpy, as in the JAX package, so one set of samples and
statistics serves both packages; the ``Normalizer`` methods take torch
tensors and compute with the same formulas.  Samples are served raw and
unpadded: normalization, the static channels and geophysical padding run
on the device inside the training step (``preprocess_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.core.padding import pad_geo
from nasa_niswan_tpu_torch.data.catalog import PACKED_VARS

DYNAMIC_CHANNELS = ("u", "v", "omega", "prec", "src")


class DeviceConst:
    """A host array copied to each device it is asked for once, and kept
    there: a captured CUDA graph (graph.py) may hold no
    host-to-device copy.  The copies are ordinary tensors (made outside
    inference mode), usable in training too."""

    def __init__(self, array):
        self.array = array
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            with torch.inference_mode(False):
                t = self._on[device] = torch.as_tensor(self.array, device=device)
        return t


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Z-score normalization constants (channel vectors for X, scalars for y)."""

    x_mean: np.ndarray  # (C,)
    x_std: np.ndarray  # (C,)
    y_mean: float
    y_std: float

    def normalize_x(self, x):
        """x: (..., C, H, W).  The constants are kept on x's device
        (``DeviceConst``, not a field)."""
        consts = self.__dict__.get("_x_consts")
        if consts is None:
            consts = self.__dict__["_x_consts"] = tuple(
                DeviceConst(np.asarray(a).reshape(-1, 1, 1))
                for a in (self.x_mean, self.x_std))
        mean, std = (c.on(x.device) for c in consts)
        return (x - mean) / std

    def normalize_y(self, y):
        return (y - self.y_mean) / self.y_std

    def unnormalize_y(self, y):
        """Invert target normalization: pred * y_std + y_mean."""
        return y * self.y_std + self.y_mean


def zscore_static(static: np.ndarray) -> np.ndarray:
    """Z-score static attribute channels (C, H, W) over (lat, lon)."""
    mean = static.mean(axis=(1, 2), keepdims=True)
    std = static.std(axis=(1, 2), keepdims=True)
    return ((static - mean) / std).astype(np.float32)


def masked_log10(x: np.ndarray) -> np.ndarray:
    """np.ma.log10(x).filled(0.0) semantics: non-positive entries map to 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log10(x, where=x > 0, out=np.zeros_like(x, dtype=np.float32))
    return out.astype(np.float32)


def reference_splits(n_usable: int) -> Tuple[int, int]:
    """(train_end, val_end) with the reference's 70/10/20 boundaries:
    floor(0.7 n), floor(0.8 n)."""
    return int(n_usable * 0.7), int(n_usable * 0.8)


def _stack_inputs(data: Dict[str, np.ndarray], species: str) -> Tuple[np.ndarray, np.ndarray]:
    src_var, conc_var = PACKED_VARS[species]
    conc = data[conc_var]
    if conc.ndim == 4:  # (T, L, H, W): surface level for the target
        conc = conc[:, 0]
    xs = np.stack(
        [data[src_var if name == "src" else name] for name in DYNAMIC_CHANNELS], axis=1
    )  # (T, 5, H, W)
    return xs.astype(np.float32), conc.astype(np.float32)


class SequenceDataset:
    """Sliding-window (T_seq, C, H, W) -> (H, W) samples for recurrent models:
    stats over the first train_end raw steps, target at the window end
    (y[seq_len-1:]), contiguous 70/10/20 split over windows."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        *,
        period: str,
        species: str = "bcb",
        sequence_length: int = 48,
        in_channels: Optional[int] = None,
        padding: Optional[Tuple[int, int]] = None,
        host_preprocessed: bool = False,
    ):
        if period not in ("train", "val", "test"):
            raise ValueError(f"bad period {period!r}")
        if isinstance(data, tuple):
            xs, y = data  # a pre-fused (frames, targets) stack
        else:
            xs, y = _stack_inputs(data, species)
        T = xs.shape[0]
        train_end, val_end = reference_splits(T)

        self.normalizer = Normalizer(
            x_mean=xs[:train_end].mean(axis=(0, 2, 3)),
            x_std=xs[:train_end].std(axis=(0, 2, 3)),
            y_mean=float(y[:train_end].mean()),
            y_std=float(y[:train_end].std()),
        )
        self.seq_len = sequence_length
        self.in_channels = in_channels if in_channels is not None else xs.shape[1]
        self.padding = padding
        self.host_preprocessed = host_preprocessed
        self.species = species

        n_static = self.in_channels - xs.shape[1]
        if n_static > 0:
            static = data.get("static") if isinstance(data, dict) else None
            if static is None or static.shape[0] < n_static:
                raise ValueError(
                    f"in_channels={self.in_channels} needs {n_static} static channels"
                )
            self.static = zscore_static(static[:n_static])
        else:
            self.static = None

        # zero-copy windows over the raw (unnormalized) slab
        windows = np.lib.stride_tricks.sliding_window_view(
            xs, (sequence_length,), axis=0
        )  # (T-seq+1, C, H, W, seq)
        targets = y[sequence_length - 1 :]
        lo, hi = {
            "train": (0, train_end),
            "val": (train_end, val_end),
            "test": (val_end, len(targets)),
        }[period]
        self._windows = windows[lo:hi]
        self._targets = targets[lo:hi]
        self.period = period

    def __len__(self) -> int:
        return len(self._targets)

    def raw_item(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """((T_seq, C, H, W) raw window, (H, W) raw target)."""
        x = np.moveaxis(self._windows[idx], -1, 0)
        return np.ascontiguousarray(x), self._targets[idx]

    def forcing_stream(self) -> Tuple[np.ndarray, np.ndarray]:
        """The contiguous raw forcing frames covering this split's windows,
        plus the aligned targets: frames (T_total, C, H, W) such that frames
        t0..t0+seq-1 feed target 0 and each later target consumes one new
        frame."""
        first = np.moveaxis(self._windows[0], -1, 0)  # (seq, C, H, W)
        rest = self._windows[1:, :, :, :, -1]  # (N-1, C, H, W)
        frames = np.concatenate([first, rest], axis=0)
        return np.ascontiguousarray(frames), self._targets.copy()

    def with_static(self, x: np.ndarray) -> np.ndarray:
        """Append the tiled static channels."""
        if self.static is None:
            return x
        tiled = np.broadcast_to(
            self.static[None], (x.shape[0], *self.static.shape)
        )
        return np.concatenate([x, tiled], axis=1)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Raw mode (default) serves the dynamic channels only; the training
        step appends the static ones on the device.  Host-preprocessed mode
        gives the full sample: normalize + static + pad."""
        x, y = self.raw_item(idx)
        if not self.host_preprocessed:
            return x, y
        norm = self.normalizer
        x = (x - norm.x_mean.reshape(-1, 1, 1)) / norm.x_std.reshape(-1, 1, 1)
        y = norm.normalize_y(y)
        x = self.with_static(x.astype(np.float32))
        if self.padding:
            x = pad_geo(torch.from_numpy(np.ascontiguousarray(x)), self.padding).numpy()
        return x.astype(np.float32), y.astype(np.float32)


class SingleStepDataset:
    """One-frame samples for UNet/pix2pix (the reference's E33OMA90D):
    inputs lagged [1:], optional 6th channel = the previous step's
    concentration (the autoregressive feedback channel), shuffled 70/10
    train/val over the first 80%, contiguous test tail, optional log10
    transform, stats over the (shuffled) train subset."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        *,
        period: str,
        species: str = "bcb",
        in_channels: int = 5,
        transform: bool = False,
        padding: Optional[Tuple[int, int]] = None,
        host_preprocessed: bool = False,
        seed: int = 0,
    ):
        xs, conc = _stack_inputs(data, species)
        x = xs[1:]  # negative lag
        y = conc[1:]
        prev = conc[:-1]  # positive-lag feedback channel
        if in_channels == 6:
            x = np.concatenate([x, prev[:, None]], axis=1)
        elif in_channels != 5:
            raise ValueError("SingleStepDataset supports in_channels 5 or 6")
        if transform:
            x = masked_log10(x)
            y = masked_log10(y)

        n = len(y)
        train_end, val_end = reference_splits(n)
        idx = np.arange(val_end)
        np.random.default_rng(seed).shuffle(idx)

        self.normalizer = Normalizer(
            x_mean=x[idx[:train_end]].mean(axis=(0, 2, 3)),
            x_std=x[idx[:train_end]].std(axis=(0, 2, 3)),
            y_mean=float(y[idx[:train_end]].mean()),
            y_std=float(y[idx[:train_end]].std()),
        )
        sel = {
            "train": idx[:train_end],
            "val": idx[train_end:val_end],
            "test": np.arange(val_end, n),
        }[period]
        self._x = x[sel]
        self._y = y[sel]
        self.padding = padding
        self.host_preprocessed = host_preprocessed
        self.in_channels = in_channels
        self.period = period
        self.species = species

    def __len__(self) -> int:
        return len(self._y)

    def raw_item(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._x[idx], self._y[idx]

    def feedback_stream(self) -> Tuple[np.ndarray, np.ndarray]:
        """The whole split as raw time-ordered arrays: (T, C, h, w) inputs
        (channel 5 = the ground-truth previous concentration when
        in_channels=6) and (T, h, w) targets, the closed-loop evaluator's
        feed.  Only meaningful for the contiguous 'test' period."""
        return self._x, self._y

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.raw_item(idx)
        if not self.host_preprocessed:
            return x, y
        norm = self.normalizer
        x = ((x - norm.x_mean.reshape(-1, 1, 1)) / norm.x_std.reshape(-1, 1, 1)).astype(np.float32)
        y = norm.normalize_y(y).astype(np.float32)
        if self.padding:
            x = pad_geo(torch.from_numpy(np.ascontiguousarray(x)), self.padding).numpy()
        return x, y


class Seq2SeqDataset:
    """Contiguous chunks for multi-step autoregressive training (config #3):
    per sample a (T, 5, H, W) forcing window, the (H, W) concentration at
    the step before the window (the initial feedback frame), and the
    (T, H, W) target series.

    Chunks stride by ``sequence_length`` (non-overlapping) so an epoch sees
    each step once; splits follow reference_splits over chunk counts.
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        *,
        period: str,
        species: str = "bcb",
        sequence_length: int = 48,
    ):
        if isinstance(data, tuple):
            xs, y = data  # a pre-fused (frames, targets) stack
        else:
            xs, y = _stack_inputs(data, species)
        T = xs.shape[0]
        # step 0 of each chunk needs conc at -1, so chunks start at 1
        n_chunks = (T - 1) // sequence_length
        starts = 1 + np.arange(n_chunks) * sequence_length
        train_end, val_end = reference_splits(n_chunks)
        lo, hi = {
            "train": (0, train_end),
            "val": (train_end, val_end),
            "test": (val_end, n_chunks),
        }[period]
        self._starts = starts[lo:hi]
        self._xs = xs
        self._y = y
        self.seq_len = sequence_length
        # stats over the steps covered by training chunks
        t_hi = starts[train_end - 1] + sequence_length if train_end else 1
        self.normalizer = Normalizer(
            x_mean=xs[1:t_hi].mean(axis=(0, 2, 3)),
            x_std=xs[1:t_hi].std(axis=(0, 2, 3)),
            y_mean=float(y[1:t_hi].mean()),
            y_std=float(y[1:t_hi].std()),
        )

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, idx: int):
        s = int(self._starts[idx])
        x = np.ascontiguousarray(self._xs[s : s + self.seq_len])
        y = self._y[s : s + self.seq_len]
        prev0 = self._y[s - 1]
        return x, prev0, y

    def continuous_stream(self):
        """The whole split as one contiguous closed-loop episode:
        ``(frames, prev0, targets)`` with frames (T, C-1, H, W) raw
        forcings, prev0 the (H, W) raw concentration one step before the
        split, targets (T, H, W)."""
        s0 = int(self._starts[0])
        s_end = int(self._starts[-1]) + self.seq_len
        frames = np.ascontiguousarray(self._xs[s0:s_end])
        return frames, self._y[s0 - 1], self._y[s0:s_end]


def preprocess_batch(x, y, normalizer: Normalizer, padded_shape, static):
    """Raw (B,[T,]C,H,W) + (B,H,W) tensors -> normalized, padded NHWC x and
    normalized y; ``static`` is the z-scored (S,H,W) tensor (appended
    after the dynamic channels) or None."""
    x = normalizer.normalize_x(x)
    if static is not None:
        x = torch.cat([x, static.expand(*x.shape[:-3], *static.shape)], dim=-3)
    if padded_shape is not None:
        x = pad_geo(x, padded_shape)
    return torch.movedim(x, -3, -1), normalizer.normalize_y(y)


def make_preprocess_fn(
    normalizer: Normalizer,
    padded_shape: Optional[Tuple[int, int]],
    *,
    static: Optional[np.ndarray] = None,
):
    """The device-side preprocessing step as a plain tensor function
    ``preprocess(x, y) -> (x, y)``: a raw (B, [T,] C, H, W) batch and
    (B, H, W) targets (tensors or numpy) become normalized, geophysically
    padded NHWC tensors on the batch's device, with the z-scored
    ``static`` channels appended (copied to each device once)."""
    static_z = None if static is None else DeviceConst(zscore_static(static))

    def preprocess(x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        st = None if static_z is None else static_z.on(x.device)
        return preprocess_batch(x, y, normalizer, padded_shape, st)

    return preprocess
