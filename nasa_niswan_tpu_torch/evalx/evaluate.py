"""Test-period evaluation (counterpart of nasa_niswan_tpu/evalx/evaluate.py).

Two inference modes for recurrent models, as in the JAX package:

* windowed (``predict_test_set``): every test step is predicted from its
  own sequence window starting at zero state; windows are gathered on the
  device from the split's uploaded frame slab (``DeviceWindowSource``);
* rollout (``predict_test_rollout``): one state-carrying rollout over the
  whole test period (rollout/autoregressive.py).

The closed-loop evaluation of a seq2seq (config #3) snapshot feeds the
model's own previous prediction back, step after step, with the (h, c)
carry and the feedback frame handed from chunk to chunk, so a whole test
period is one continuous episode.  On a CUDA device each chunk is one
CUDA graph replay (rollout/graph.py), as the JAX package jit-compiles the
chunk's scan; chunks are fetched one dispatch behind (``ChunkDrain``).
The closed loop of a 6-channel single-step (UNet-6ch) snapshot
(``predict_test_feedback``) carries its raw feedback frame from chunk to
chunk the same way, each chunk one CUDA graph replay on the card; the
other single-step snapshots run ``predict_test_set`` over their one-frame
samples.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves
from nasa_niswan_tpu_torch.core.padding import crop_to_grid, pad_geo
from nasa_niswan_tpu_torch.data.dataset import Normalizer
from nasa_niswan_tpu_torch.data.pipeline import ChunkDrain, async_batches, batch_iterator
from nasa_niswan_tpu_torch.evalx import metrics as M
from nasa_niswan_tpu_torch.models.convlstm import CellFn, ConvLSTMConfig, cell_weights
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward
from nasa_niswan_tpu_torch.ops.seq2seq_bptt import feedback_step
from nasa_niswan_tpu_torch.rollout.autoregressive import (
    flat_state,
    make_rollout_fn,
    nest_state,
    serving_weights,
    zero_state,
)
from nasa_niswan_tpu_torch.rollout.graph import GraphRunner


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def predict_test_set(
    bundle, params, state, dataset, *, padded_shape, batch_size: int = 8,
    static: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Windowed inference over a test dataset (a sequence model's windows
    or a single-step model's one-frame samples); returns physical-unit
    GTs / PDs shaped (N, h, w), on the parameters' device.

    Sequence datasets with a frame slab (``forcing_stream``) run from the
    device: the slab is uploaded once and each batch's windows are gathered
    by start index (windows overlap by seq - 1 frames, so host batches would
    send every frame ~seq times).  The tail batch is padded to the batch
    size by repeating its last window.  Other datasets stream host batches
    through ``async_batches``."""
    from nasa_niswan_tpu_torch.train.loop import (
        DeviceWindowSource,
        make_device_eval_step,
        make_eval_step,
    )

    norm = dataset.normalizer
    grid_shape = tuple(dataset[0][1].shape[-2:])
    device = _device_of(params)
    drain = ChunkDrain()  # fetch one batch behind the dispatch
    if hasattr(dataset, "forcing_stream"):
        src = DeviceWindowSource(dataset, device)
        eval_step = make_device_eval_step(
            bundle, norm, src, padded_shape=padded_shape, grid_shape=grid_shape,
            static=static, unnormalize=True,
        )
        for s in range(0, src.n, batch_size):
            idx = np.arange(s, min(s + batch_size, src.n))
            n_valid = len(idx)
            if n_valid < batch_size:
                idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_valid)])
            _, pred = eval_step(params, state, torch.from_numpy(idx))
            drain.push(pred, lambda d, n=n_valid: np.asarray(d)[:n])
        return {"GTs": src.targets.cpu().numpy(), "PDs": np.concatenate(drain.finish())}
    eval_step = make_eval_step(
        bundle, norm, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, unnormalize=True,
    )
    gts = []
    for x_raw, y_raw in async_batches(dataset, batch_size, shuffle=False,
                                      drop_last=False, device=device):
        _, pred = eval_step(params, state, x_raw, y_raw)
        gts.append(y_raw.cpu().numpy())
        drain.push(pred)
    return {"GTs": np.concatenate(gts), "PDs": np.concatenate(drain.finish())}


def predict_test_rollout(
    config: ConvLSTMConfig, params, dataset, *, padded_shape, static=None,
) -> Dict[str, np.ndarray]:
    """One state-carrying rollout over a SequenceDataset's whole test
    period; the predictions before the first full window are dropped."""
    norm = dataset.normalizer
    grid_shape = tuple(dataset[0][1].shape[-2:])
    rollout = make_rollout_fn(
        config, norm, padded_shape=padded_shape, grid_shape=grid_shape,
        static=static, unnormalize=True,
    )
    frames, targets = dataset.forcing_stream()
    preds, _ = rollout(params, frames[None])
    return {"GTs": targets, "PDs": preds[0, dataset.seq_len - 1 :].cpu().numpy()}


def pad_tail_chunk(x_chunk, chunk: int):
    """Repeat-pad a short tail chunk (leading time axis) to the chunk length,
    so one chunk length needs one CUDA graph.  Tensors pad on their device."""
    n_valid = x_chunk.shape[0]
    if n_valid == chunk:
        return x_chunk
    if isinstance(x_chunk, torch.Tensor):
        return torch.cat([x_chunk, x_chunk[-1:].expand(chunk - n_valid, *x_chunk.shape[1:])])
    return np.concatenate([x_chunk, np.repeat(x_chunk[-1:], chunk - n_valid, axis=0)])


def run_chunked_episode_carry(run_chunk, carry, frames, chunk_steps: int):
    """Drive a fixed-size-chunk episode over ``frames`` (T leading): the tail
    chunk is repeat-padded to the chunk length, the carry threads through
    every chunk (one episode, no resets), and the padding is trimmed from
    the predictions.  ``run_chunk(*carry, x_chunk) -> (*carry, preds)``.
    Returns (numpy predictions, final carry); a padded tail chunk advances
    the carry over the padding frames, so the final carry continues the
    episode only when ``T % chunk_steps == 0``.  A ``chunk_steps`` above T
    is kept (a short stream is padded up to it, as an exported artifact's
    fixed length needs); callers that want no padding pass
    ``min(chunk_steps, T)``.

    Chunk k+1 is dispatched before chunk k's predictions are fetched: each
    push to the ``ChunkDrain`` starts its chunk's copy to pinned host memory
    and completes the previous one, so the card runs the next chunk while
    the host takes the last."""
    T = frames.shape[0]
    drain = ChunkDrain()
    for s in range(0, T, chunk_steps):
        x_chunk = frames[s : s + chunk_steps]
        n_valid = x_chunk.shape[0]
        *carry, p = run_chunk(*carry, pad_tail_chunk(x_chunk, chunk_steps))
        drain.push(p, lambda d, n=n_valid: np.asarray(d)[:n])
    return np.concatenate(drain.finish()), carry


def _run_chunked_episode(run_chunk, carry, frames, chunk_steps: int):
    """``run_chunked_episode_carry``'s predictions alone."""
    preds, _ = run_chunked_episode_carry(run_chunk, carry, frames, chunk_steps)
    return preds


def make_closed_loop_chunk(
    config: ConvLSTMConfig,
    normalizer: Normalizer,
    *,
    padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
    cell_fn: CellFn = fused_cell_forward,
):
    """Returns ``run_chunk(params, state, prev_norm, x_chunk) -> (state,
    prev_norm, preds)``: x_chunk raw (Tc, C-1, h, w), prev_norm (1, h, w)
    normalized, state the per-layer (h, c) carry (1, H, W, hidden) f32,
    preds (Tc, h, w) in physical units.  Runs on the parameters' device,
    under ``torch.inference_mode``; on a CUDA device each call replays the
    chunk's CUDA graph (``run_chunk.runner``), ``run_chunk.eager`` runs the
    same body without one.  The forcings are normalized, padded and cast
    once per chunk; per step only the one-channel feedback frame is
    rebuilt."""
    dt = config.torch_dtype

    def body(params, weights, x_chunk, prev_norm, *state):
        xn = normalizer.normalize_x(x_chunk)
        # (Tc, 1, H, W, C-1) in the compute dtype, once per chunk
        xs = torch.movedim(pad_geo(xn, padded_shape), 1, -1)[:, None].to(dt)
        st, prev, preds = nest_state(state), prev_norm, []
        head_w, head_b = params["head"]["w"], params["head"]["b"]
        for t in range(xs.shape[0]):
            st, prev = feedback_step(weights["cells"], head_w, head_b, xs[t], prev, st,
                                     dt, padded_shape, grid_shape, cell_fn)
            preds.append(prev)
        return (prev, normalizer.unnormalize_y(torch.cat(preds)), *flat_state(st))

    runner = GraphRunner(body, lambda params: serving_weights(params, config),
                         warm=lambda xs: [xs[0][:1], *xs[1:]])  # one step

    def _inputs(params, state, prev_norm, x_chunk):
        dev = _device_of(params)
        st = [torch.as_tensor(t, device=dev, dtype=torch.float32).contiguous()
              for t in flat_state(state)]
        return [torch.as_tensor(x_chunk, device=dev),
                torch.as_tensor(prev_norm, device=dev), *st]

    def _out(out):
        prev, preds, *st = out
        return nest_state(st), prev, preds

    def run(params, state, prev_norm, x_chunk, graph: bool):
        with torch.inference_mode():
            inputs = _inputs(params, state, prev_norm, x_chunk)
            if graph and inputs[0].is_cuda:
                return _out(runner(params, inputs))
            return _out(body(params, cell_weights(params, config), *inputs))

    def run_chunk(params, state, prev_norm, x_chunk):
        return run(params, state, prev_norm, x_chunk, graph=True)

    run_chunk.runner = runner
    run_chunk.eager = lambda params, state, prev_norm, x_chunk: run(
        params, state, prev_norm, x_chunk, graph=False)
    return run_chunk


def zero_closed_loop_state(config: ConvLSTMConfig, padded_shape, device=None):
    """Zero (h, c) carry for the closed-loop chunk (batch 1)."""
    return zero_state(config, 1, padded_shape, device)


def predict_test_closed_loop(
    config: ConvLSTMConfig, params, dataset, *, padded_shape, chunk_steps: int = 480,
) -> Dict[str, np.ndarray]:
    """Closed-loop feedback evaluation over a ``Seq2SeqDataset``'s whole
    split, the deployment condition of a ``--mode seq2seq`` snapshot: each
    step's feedback is the model's own previous prediction (the ground truth
    seeds step 0 only), the carry crosses chunk boundaries.  Returns
    physical-unit GTs / PDs shaped (T, h, w); runs on the parameters'
    device."""
    frames, prev0, targets = dataset.continuous_stream()
    norm = dataset.normalizer
    device = _device_of(params)
    run_chunk = make_closed_loop_chunk(
        config, norm, padded_shape=padded_shape, grid_shape=tuple(targets.shape[-2:])
    )
    state = zero_closed_loop_state(config, padded_shape, device)
    prev_norm = torch.as_tensor(
        np.asarray(norm.normalize_y(prev0), np.float32)[None], device=device
    )
    preds = _run_chunked_episode(
        lambda st, prev, x: run_chunk(params, st, prev, x),
        [state, prev_norm], torch.as_tensor(frames, device=device),
        min(chunk_steps, frames.shape[0]),
    )
    return {"GTs": targets, "PDs": preds}


def make_feedback_chunk(
    bundle, normalizer: Normalizer, *, padded_shape: Tuple[int, int],
    grid_shape: Tuple[int, int],
):
    """Returns ``run_chunk(params, state, prev_raw, x_chunk) -> (state,
    prev_raw, preds)`` for a 6-channel single-step model: x_chunk raw
    (Tc, 6, h, w), channel 5 of each step replaced by ``prev_raw`` (h, w),
    the previous prediction in raw units; the model runs in eval mode on
    ``state`` (its BatchNorm statistics, passed through); preds (Tc, h, w)
    in physical units.  Runs on the parameters' device under
    ``torch.inference_mode``; on a CUDA device each call replays the
    chunk's CUDA graph, keyed on the weights and the state
    (``run_chunk.runner``), and ``run_chunk.eager`` runs the same body
    without one."""

    def body(model, _, x_chunk, prev_raw):
        params, state = model  # the graph's key: weights and state
        preds = []
        for t in range(x_chunk.shape[0]):
            x_t = torch.cat([x_chunk[t, :5], prev_raw[None]])  # X[:, -1] = pred
            frame = torch.movedim(pad_geo(normalizer.normalize_x(x_t), padded_shape), 0,
                                  -1)[None].float()
            out, _ = bundle.apply(params, state, frame, training=False)
            prev_raw = normalizer.unnormalize_y(crop_to_grid(out[..., 0], grid_shape)[0])
            preds.append(prev_raw)
        return prev_raw, torch.stack(preds)

    runner = GraphRunner(body, lambda model: None,
                         warm=lambda xs: [xs[0][:1], *xs[1:]])  # one step

    def run(params, state, prev_raw, x_chunk, graph: bool):
        with torch.inference_mode():
            dev = _device_of(params)
            inputs = [torch.as_tensor(x_chunk, device=dev),
                      torch.as_tensor(prev_raw, device=dev, dtype=torch.float32)]
            if graph and dev.type == "cuda":
                prev, preds = runner((params, state), inputs)
            else:
                prev, preds = body((params, state), None, *inputs)
        return state, prev, preds

    def run_chunk(params, state, prev_raw, x_chunk):
        return run(params, state, prev_raw, x_chunk, graph=True)

    run_chunk.runner = runner
    run_chunk.eager = lambda params, state, prev_raw, x_chunk: run(
        params, state, prev_raw, x_chunk, graph=False)
    return run_chunk


def predict_test_feedback(bundle, params, state, dataset, *, padded_shape,
                          chunk_steps: int = 480) -> Dict[str, np.ndarray]:
    """The closed loop of a 6-channel single-step (UNet-6ch) snapshot over
    a ``SingleStepDataset`` split in time order: channel 5 of every frame
    after the first carries the model's own previous prediction, not the
    dataset's ground truth.  The model state and the raw feedback frame
    cross fixed-size chunks, so the split is one continuous episode.
    Returns physical-unit GTs / PDs shaped (T, h, w); runs on the
    parameters' device."""
    frames, targets = dataset.feedback_stream()  # raw (T, 6, h, w) / (T, h, w)
    if frames.shape[1] != 6:
        raise ValueError("feedback evaluation needs in_channels=6")
    device = _device_of(params)
    run_chunk = make_feedback_chunk(bundle, dataset.normalizer, padded_shape=padded_shape,
                                    grid_shape=tuple(targets.shape[-2:]))
    # the ground-truth previous concentration seeds step 0 only
    prev_raw = torch.as_tensor(np.asarray(frames[0, 5], np.float32), device=device)
    preds = _run_chunked_episode(
        lambda st, prev, x: run_chunk(params, st, prev, x),
        [state, prev_raw], torch.as_tensor(frames, device=device),
        min(chunk_steps, frames.shape[0]),
    )
    return {"GTs": targets, "PDs": preds}


def predict_test_hidden(
    config: ConvLSTMConfig, params, dataset, *, padded_shape, batch_size: int = 8,
    static: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-window per-step head taps, the reference's HSs buffer: each
    window from zero state, physical units, (N, T, h, w)."""
    rollout = make_rollout_fn(
        config, dataset.normalizer, padded_shape=padded_shape,
        grid_shape=tuple(dataset[0][1].shape[-2:]), static=static, unnormalize=True,
    )
    drain = ChunkDrain()
    for x_raw, _ in batch_iterator(dataset, batch_size, shuffle=False, drop_last=False):
        taps, _ = rollout(params, x_raw)
        drain.push(taps)
    return np.concatenate(drain.finish())


def evaluation_report(
    gts: np.ndarray, pds: np.ndarray, lat, lon, *, unit_scale: float = 1.0
) -> Dict:
    """The reference's metric battery over (N, H, W) ground truth and
    predictions (test.ipynb cells 12-44)."""
    gts = gts * unit_scale
    pds = pds * unit_scale
    temporal = M.r2_temporal(gts, pds).numpy()
    spatial = M.r2_spatial(gts, pds).numpy()
    weight = gts.mean(axis=0)
    bands = {
        "tropical": (-21, 21),
        "northern_mid": (21, 61),
        "northern_polar": (61, 90),
        "southern_mid": (-61, -21),
        "southern_polar": (-90, -61),
    }
    band_r2 = {
        name: float(M.lat_band_weighted_r2(spatial, weight, lat, band))
        for name, band in bands.items()
    }
    regions = {
        region: float(M.r2(M.regional_slice(gts, lat, lon, region),
                           M.regional_slice(pds, lat, lon, region)))
        for region in M.REGIONS
    }
    return {
        "temporal_r2": temporal,
        "temporal_r2_summary": {
            "mean": float(temporal.mean()),
            "median": float(np.median(temporal)),
            "max": float(temporal.max()),
            "min": float(temporal.min()),
        },
        "spatial_r2": spatial,
        "band_weighted_r2": band_r2,
        "regional_r2": regions,
        "pearson_r": float(M.pearson_r(gts, pds)),
        "global_r2": float(M.r2(gts, pds)),
    }


def monthly_breakdown(
    gts: np.ndarray, pds: np.ndarray, months: np.ndarray, lat, lon, *, which=(2, 8),
) -> Dict[int, Dict[str, float]]:
    """Month-conditioned regional R^2 (test.ipynb cells 36, 40: the Feb/Aug
    comparison).  ``months``: (N,) month number per timestep."""
    months = np.asarray(months)
    out: Dict[int, Dict[str, float]] = {}
    for m in which:
        sel = months == m
        if not sel.any():
            continue
        out[m] = {
            region: float(M.r2(M.regional_slice(gts[sel], lat, lon, region),
                               M.regional_slice(pds[sel], lat, lon, region)))
            for region in M.REGIONS
        }
    return out


def save_animation_frames(
    fields: np.ndarray, out_dir: str, *, prefix: str = "frame", cmap: str = "viridis",
    every: int = 1, projection: Optional[str] = None, grid_lat=None, grid_lon=None,
) -> int:
    """Per-timestep maps as PNG frames (test.ipynb cells 31-34's animation);
    returns the frame count.  ``projection="robinson"`` (with grid_lat /
    grid_lon) renders through ``evalx.plots.plot_global_map``.  Needs
    matplotlib."""
    from nasa_niswan_tpu_torch.evalx.plots import _require_mpl

    plt = _require_mpl()
    os.makedirs(out_dir, exist_ok=True)
    vmin, vmax = float(np.min(fields)), float(np.max(fields))
    count = 0
    for t in range(0, len(fields), every):
        path = os.path.join(out_dir, f"{prefix}-{t:05d}.png")
        if projection is not None:
            from nasa_niswan_tpu_torch.evalx.plots import plot_global_map

            if grid_lat is None or grid_lon is None:
                nlat, nlon = fields[t].shape
                grid_lat = np.linspace(-90, 90, nlat)
                grid_lon = np.linspace(-180, 180, nlon, endpoint=False)
            fig = plot_global_map(
                fields[t], grid_lat, grid_lon, projection=projection,
                title=f"t={t}", save_path=path, cmap=cmap, vmin=vmin, vmax=vmax,
            )
        else:
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.imshow(fields[t], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
            ax.set_title(f"t={t}")
            fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        count += 1
    return count


def save_test_results(path_dir: str, gts: np.ndarray, pds: np.ndarray) -> str:
    """test-results.npy in the reference layout: two consecutive np.save's
    (GTs then PDs) in one file (test.ipynb cell 9)."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, "test-results.npy")
    with open(path, "wb") as f:
        np.save(f, gts)
        np.save(f, pds)
    return path


def load_test_results(path: str):
    with open(path, "rb") as f:
        gts = np.load(f)
        pds = np.load(f)
    return gts, pds
