"""Serving entry point: ``python -m nasa_niswan_tpu_torch.rollout --run-dir <snapshot>``
(counterpart of ``python -m nasa_niswan_tpu.rollout``).

Streams a snapshot's forcing frames through the state-carrying rollout in
fixed-size chunks (one continuous episode, no state resets) and writes the
physical-unit predictions to netCDF under the packed file's concentration
variable name.  On the card every chunk is one CUDA graph replay
(graph.py), captured once per chunk shape: a repeat-padded tail
chunk keeps one shape.  Chunks are fetched one dispatch behind
(``data/pipeline.ChunkDrain``).  The carry can be persisted
(``--state-out``) and resumed (``--state-in``) so emulation continues
bit-exactly across invocations, and the carry file is the JAX package's
layout, so either package resumes the other's.

Routes: LSTM open loop (configs #1/#2) through ``make_rollout_fn`` or a
frozen ``--artifact`` (rollout/export.py); LSTM seq2seq (config #3) closed
loop, the feedback channel carrying the model's own previous prediction;
the single-step families through their evaluation paths (UNet-6ch's closed
loop, ``evalx.evaluate.predict_test_feedback``, each chunk a graph replay
on the card; the others' one-frame samples), over the whole split and
with no carry to persist, so ``--state-in``, ``--state-out``,
``--artifact``, ``--skip`` and ``--steps`` are refused there.

``--sharded LAT LON`` serves an LSTM snapshot, open or closed loop, with
the padded grid cut into LAT x LON tiles over as many ranks, one device
each (``cuda:0`` .., or CPU processes with ``--device cpu``), started by
``parallel/launch.spawn`` (parallel/spatial.py: halo exchange, the fused
cell on each tile).  Every rank reads the snapshot and the stream; rank 0
writes the predictions, the carry (gathered to the global layout, so a
sharded run resumes an unsharded one's carry and the reverse) and the
summary.  On the cards each sharded chunk is one CUDA graph replay as
well (parallel/spatial.py), fetched one chunk behind.  It is refused
with ``--artifact`` (a single-device program), for a single-step
snapshot, and when the padded grid does not tile evenly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _positive(name: str, v: int) -> int:
    if v <= 0:
        raise SystemExit(f"{name} must be positive, got {v}")
    return v


def _slice_stream(frames: np.ndarray, skip: int, steps):
    if skip >= frames.shape[0]:
        raise SystemExit(f"--skip {skip} >= available stream length {frames.shape[0]}")
    out = frames[skip:]
    if steps is not None:
        if steps > out.shape[0]:
            raise SystemExit(
                f"--steps {steps} > available stream length {out.shape[0]} "
                f"after --skip {skip}"
            )
        out = out[:steps]
    return out


def _upload(frames: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


def _device_resident(frames: np.ndarray, limit_gb: float, device):
    """The sliced forcing stream uploaded to ``device`` once when it takes at
    most ``limit_gb`` GB (per-chunk slices then move no host data), else
    the host array, whose chunks are copied as they are served.

    Falls back to host streaming if the device allocator refuses the slab —
    params/activations may leave less free memory than the size check
    assumes; serving must not fail where streaming would have worked.  Only
    allocator exhaustion (``torch.OutOfMemoryError``) is downgraded; any
    other failure is a real bug and re-raises.  Under ``--sharded`` each
    rank decides for itself and holds the whole slab: it preprocesses the
    whole frame before it takes its tile."""
    if limit_gb > 0 and frames.nbytes <= limit_gb * 1e9:
        try:
            return _upload(frames, device)
        except torch.OutOfMemoryError as e:
            print(
                f"serve: device-resident upload of {frames.nbytes/1e9:.2f} "
                f"GB failed ({type(e).__name__}); streaming chunks from "
                "host instead (--resident-gb 0 silences this)",
                file=sys.stderr,
            )
    return frames


def _write_predictions(path: str, preds: np.ndarray, species: str, *, t0_index: int,
                       fmt: str) -> str:
    """Predictions -> netCDF with a CF no-leap time and lat/lon coordinates,
    under the packed file's concentration variable name (``PACKED_VARS``),
    so downstream tooling reads it like E33OMA output."""
    from nasa_niswan_tpu_torch.core.grid import GridSpec
    from nasa_niswan_tpu_torch.data.catalog import PACKED_VARS
    from nasa_niswan_tpu_torch.data.ncio import write_nc

    T, h, w = preds.shape
    grid = GridSpec(nlat=h, nlon=w)
    var = PACKED_VARS.get(species, (None, f"{species}_conc"))[1]
    # model step = 30 minutes; time in hours since the stream origin, offset
    # by where this invocation started
    tvals = (t0_index + np.arange(T, dtype=np.float64)) * 0.5
    return write_nc(
        path,
        {"time": T, "lat": h, "lon": w},
        {
            var: (("time", "lat", "lon"), preds.astype(np.float32)),
            "lat": (("lat",), grid.lat.astype(np.float32)),
            "lon": (("lon",), grid.lon.astype(np.float32)),
        },
        time_values=tvals,
        fmt=fmt,
    )


def _parse(argv):
    p = argparse.ArgumentParser(
        description="Serve a trained emulator: chunked rollout -> netCDF.")
    p.add_argument("--run-dir", required=True,
                   help="snapshot dir holding configurations.json + epoch-NNN/")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch checkpoint to load (default: latest)")
    p.add_argument("--period", default="test", choices=("train", "val", "test"),
                   help="which split supplies the forcing stream")
    p.add_argument("--steps", type=int, default=None,
                   help="serve this many steps (default: the whole stream)")
    p.add_argument("--skip", type=int, default=0,
                   help="skip this many leading stream steps (use with "
                        "--state-in to continue a previous invocation)")
    p.add_argument("--chunk", type=int, default=480,
                   help="steps per chunk (one CUDA graph, replayed)")
    p.add_argument("--out", default=None,
                   help="output netCDF path (default: <run-dir>/predictions.nc)")
    p.add_argument("--fmt", default="netcdf3", choices=("netcdf3", "netcdf4", "cdf5"))
    p.add_argument("--state-in", default=None,
                   help="resume the rollout carry from this .npz")
    p.add_argument("--state-out", default=None,
                   help="persist the final carry to this .npz (requires "
                        "steps %% chunk == 0: a repeat-padded tail would "
                        "advance the carry over padding frames)")
    p.add_argument("--artifact", default=None,
                   help="serve this exported rollout (rollout/export.py, a "
                        ".pt2 file) instead of the checkpoint's live rollout "
                        "(LSTM open-loop snapshots only)")
    p.add_argument("--resident-gb", type=float, default=4.0,
                   help="upload the whole forcing stream to the device once "
                        "when it fits in this many GB (0 disables)")
    p.add_argument("--sharded", nargs=2, type=int, default=None,
                   metavar=("LAT", "LON"),
                   help="shard the padded grid over a (lat, lon) mesh of "
                        "LAT*LON ranks, one device each")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu to ask "
                        "for the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    _positive("--chunk", args.chunk)
    if args.steps is not None:
        _positive("--steps", args.steps)
    if args.skip < 0:
        raise SystemExit(f"--skip must be >= 0, got {args.skip}")
    if args.sharded:
        from nasa_niswan_tpu_torch.parallel import launch

        lat, lon = args.sharded
        _check_sharded(args, lat, lon)
        argv = sys.argv[1:] if argv is None else list(argv)
        return launch.spawn(_serve_rank, lat * lon, torch.device(args.device).type,
                            argv)[0]

    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    return serve(args, resolve_device(args.device))


def _check_sharded(args, lat: int, lon: int) -> None:
    """``--sharded``'s refusals, before any rank starts (the JAX CLI's
    ``_build_mesh`` and its flag checks)."""
    from nasa_niswan_tpu_torch.parallel.launch import check_devices
    from nasa_niswan_tpu_torch.train.config import TrainConfig

    if lat < 1 or lon < 1:
        raise SystemExit(f"--sharded {lat} {lon}: both must be >= 1")
    if args.artifact:
        raise SystemExit("--sharded serves the live sharded rollout; a frozen "
                         "--artifact is a single-device program")
    cfg = TrainConfig.load(os.path.join(args.run_dir, "configurations.json"))
    if cfg.family != "LSTM":
        raise SystemExit("--sharded applies to LSTM-family snapshots (the recurrent "
                         f"scan is what shards); this is {cfg.family}")
    H, W = cfg.input_size
    if H % lat or W % lon:
        raise SystemExit(f"--sharded {lat} {lon}: the padded grid {H}x{W} must tile "
                         "evenly (H % lat == 0 and W % lon == 0)")
    try:
        check_devices(lat * lon, torch.device(args.device).type)
    except RuntimeError as e:
        raise SystemExit(f"--sharded {lat} {lon}: {e}") from None


def _serve_rank(rank: int, argv):
    """One rank of ``--sharded``: the (1, lat, lon) mesh, then ``serve``."""
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh

    args = _parse(argv)
    mesh = make_mesh(1, *args.sharded)
    return serve(args, mesh.device, mesh)


def serve(args, device: torch.device, mesh=None):
    """Serve the snapshot on ``device``, sharded over ``mesh`` when given
    (every rank calls it; rank 0 writes).  Returns the summary."""
    from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot
    from nasa_niswan_tpu_torch.rollout.autoregressive import model_days_per_min
    from nasa_niswan_tpu_torch.rollout.export import load_rollout_state, save_rollout_state

    artifact = None
    if args.artifact:
        from nasa_niswan_tpu_torch.rollout.export import load_rollout_info

        try:
            artifact = load_rollout_info(args.artifact, device=device)
        except ValueError as e:
            raise SystemExit(f"--artifact: {e}") from None
    snap = load_snapshot(args.run_dir, epoch=args.epoch, period=args.period, device=device)
    recurrent = snap.bundle.is_sequence
    if not recurrent:
        # single-step families have no recurrent carry to persist
        for flag, name in ((args.state_in, "--state-in"), (args.state_out, "--state-out"),
                           (args.artifact, "--artifact")):
            if flag:
                raise SystemExit(f"{name} applies to LSTM-family snapshots; "
                                 f"this is {snap.bundle.family}")
        if args.skip or args.steps:
            raise SystemExit("--skip/--steps drive the recurrent stream; single-step "
                             "families serve their full split")
    out_path = args.out or os.path.join(args.run_dir, "predictions.nc")
    state_in = prev_in = None
    if args.state_in:
        state_in, prev_in = load_rollout_state(args.state_in)

    t_serve = time.perf_counter()
    if snap.closed_loop:
        if artifact is not None:
            raise SystemExit("--artifact serves the open-loop rollout; this is a "
                             "seq2seq (closed-loop) snapshot")
        preds, final_state, prev_norm = _serve_closed_loop(snap, args, state_in,
                                                           prev_in, device, mesh)
    elif recurrent:
        preds, final_state = _serve_open_loop(snap, args, state_in, artifact, device, mesh)
        prev_norm = None
    else:
        preds = _serve_single_step(snap, args)
    elapsed = time.perf_counter() - t_serve
    if mesh is not None:
        from nasa_niswan_tpu_torch.parallel.spatial import gather_state

        final_state = gather_state(final_state, mesh)
        if mesh.rank:
            return None

    if args.state_out:
        save_rollout_state(args.state_out, final_state, prev_norm=prev_norm)
    _write_predictions(out_path, preds, snap.cfg.species, t0_index=args.skip, fmt=args.fmt)
    summary = {
        "steps": int(preds.shape[0]),
        "elapsed_s": round(elapsed, 3),
        "model_days_per_min": round(model_days_per_min(preds.shape[0], elapsed), 2),
        "route": ("closed_loop" if snap.closed_loop
                  else "open_loop" if recurrent else "single_step"),
        "cold_start": args.state_in is None,
        # a cold recurrent carry spins up over the first window
        "suggested_spinup_steps": (
            0 if (args.state_in or not recurrent or snap.closed_loop)
            else snap.cfg.sequence_length - 1
        ),
        "out": out_path,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "sharded": list(mesh.shape[1:]) if mesh is not None else None,
    }
    with open(os.path.join(args.run_dir, "serve_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def _check_state_out(args, T: int, chunk: int, what: str) -> None:
    if args.state_out and T % chunk:
        raise SystemExit(
            f"--state-out needs steps ({T}) divisible by {what} ({chunk}): the "
            "repeat-padded tail chunk would advance the carry over padding frames"
        )


def _serve_open_loop(snap, args, state_in, artifact, device, mesh=None):
    """Configs #1/#2: the rollout over the raw forcing stream, chunked with
    a carried state; through ``artifact`` (``load_rollout_info``'s result)
    when one was given, sharded over ``mesh`` when given."""
    from nasa_niswan_tpu_torch.evalx.evaluate import run_chunked_episode_carry
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn

    ds = snap.dataset
    frames, _ = ds.forcing_stream()  # (T_total, C, h, w) raw dynamic channels
    frames = _slice_stream(frames, args.skip, args.steps)
    T = frames.shape[0]
    grid_shape = tuple(ds[0][1].shape[-2:])
    if artifact is not None:
        from nasa_niswan_tpu_torch.rollout.export import initial_rollout_state

        fn, sig = artifact
        if sig[0] != 1 or sig[2] != frames.shape[1]:
            raise SystemExit(
                f"artifact signature {sig} does not match the stream "
                f"(batch 1, {frames.shape[1]} channels)"
            )
        chunk = sig[1]
        _check_state_out(args, T, chunk, "the artifact's chunk")
        state = state_in if state_in is not None else initial_rollout_state(
            snap.bundle.config, 1, snap.padded_shape)
        run = lambda x_chunk, st: fn(x_chunk[None], st)  # noqa: E731
    else:
        chunk = min(args.chunk, T)
        _check_state_out(args, T, chunk, "--chunk")
        geo = dict(padded_shape=snap.padded_shape, grid_shape=grid_shape,
                   static=snap.static)
        if mesh is not None:
            from nasa_niswan_tpu_torch.parallel.spatial import (
                make_sharded_rollout_fn,
                scatter_state,
            )

            rollout = make_sharded_rollout_fn(snap.bundle.config, ds.normalizer, mesh,
                                              **geo)
            state_in = None if state_in is None else scatter_state(state_in, mesh)
        else:
            rollout = make_rollout_fn(snap.bundle.config, ds.normalizer, **geo)
        state = state_in  # None: zero carry
        run = lambda x_chunk, st: rollout(snap.params, x_chunk[None], st)  # noqa: E731

    def run_chunk(st, x_chunk):
        p, st = run(x_chunk, st)
        return st, p[0]

    # an artifact's chunk is its fixed length and may exceed the stream
    # (the live route clamps above)
    preds, (state,) = run_chunked_episode_carry(
        run_chunk, [state], _device_resident(frames, args.resident_gb, device), chunk,
    )
    return preds, state


def _serve_single_step(snap, args) -> np.ndarray:
    """The single-step families over the whole split: UNet-6ch's closed
    loop in chunks of ``--chunk``, the others' one-frame samples."""
    from nasa_niswan_tpu_torch.evalx.evaluate import predict_test_feedback, predict_test_set

    if snap.feedback_single:
        out = predict_test_feedback(snap.bundle, snap.params, snap.eval_state, snap.dataset,
                                    padded_shape=snap.padded_shape, chunk_steps=args.chunk)
    else:
        out = predict_test_set(snap.bundle, snap.params, snap.eval_state, snap.dataset,
                               padded_shape=snap.padded_shape, static=snap.static)
    return out["PDs"]


def _serve_closed_loop(snap, args, state_in, prev_in, device, mesh=None):
    """Config #3: the feedback channel carries the model's own previous
    prediction; re-seeded from the ground truth only at a cold start;
    sharded over ``mesh`` when given."""
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        make_closed_loop_chunk,
        run_chunked_episode_carry,
        zero_closed_loop_state,
    )

    ds = snap.dataset
    frames, prev0, targets = ds.continuous_stream()
    norm = ds.normalizer
    if args.state_in and prev_in is None:
        raise SystemExit(
            "--state-in carry lacks the feedback frame (prev_norm): it was "
            "saved from an open-loop rollout, not a seq2seq episode"
        )
    if state_in is None:
        state = zero_closed_loop_state(snap.bundle.config, snap.padded_shape, device)
        # a cold start at an offset seeds the feedback from the ground truth
        # at that step
        seed = prev0 if args.skip == 0 else targets[args.skip - 1]
        prev_norm = np.asarray(norm.normalize_y(seed), np.float32)[None]
    else:
        state, prev_norm = state_in, prev_in
    frames = _slice_stream(frames, args.skip, args.steps)
    T = frames.shape[0]
    chunk = min(args.chunk, T)
    _check_state_out(args, T, chunk, "--chunk")
    geo = dict(padded_shape=snap.padded_shape, grid_shape=tuple(targets.shape[-2:]))
    if mesh is not None:
        from nasa_niswan_tpu_torch.parallel.spatial import (
            make_sharded_feedback_rollout,
            scatter_state,
        )

        run_chunk = make_sharded_feedback_rollout(snap.bundle.config, norm, mesh, **geo)
        state = scatter_state(state, mesh)
    else:
        run_chunk = make_closed_loop_chunk(snap.bundle.config, norm, **geo)
    preds, (state, prev_norm) = run_chunked_episode_carry(
        lambda st, prev, x: run_chunk(snap.params, st, prev, x),
        [state, prev_norm], _device_resident(frames, args.resident_gb, device), chunk,
    )
    return preds, state, prev_norm


if __name__ == "__main__":
    main()
