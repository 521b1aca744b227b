"""Evaluation entry point: ``python -m nasa_niswan_tpu_torch.evalx --run-dir <snapshot>``
(counterpart of ``python -m nasa_niswan_tpu.evalx``).

Reloads configurations.json and the checkpoint, streams the test split,
computes the metric battery, and writes ``test-results.npy`` and
``evaluation.json`` into the run directory, printing the JAX CLI's report
lines.  Runs on the card (``--device cuda``, the default) unless asked for
the CPU.  Routes as the JAX CLI does: a seq2seq snapshot and a UNet-6ch
snapshot run their closed loops, the other single-step snapshots their
one-frame samples (``--mode rollout``, ``--export-hidden``, ``--oat`` and
``--export-artifact`` drive the ConvLSTM).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained emulator.")
    p.add_argument("--run-dir", required=True,
                   help="snapshot dir holding configurations.json + epoch-NNN/")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch checkpoint to load (default: latest)")
    p.add_argument("--mode", choices=("windowed", "rollout"), default="windowed")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--export-hidden", action="store_true",
                   help="also save per-window per-step head taps to HSs.npy")
    p.add_argument("--oat", action="store_true",
                   help="run the OAT sensitivity sweep and save "
                        "oat_sensitivity.npz (+ a boxplot where matplotlib is)")
    p.add_argument("--export-artifact", metavar="PATH", default=None,
                   help="also export the rollout (weights and normalization "
                        "baked in) as a .pt2 serving artifact (rollout/export.py)")
    p.add_argument("--artifact-chunk", type=int, default=48,
                   help="chunk_steps the exported artifact accepts")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda; cpu to ask "
                        "for the CPU)")
    args = p.parse_args(argv)

    from nasa_niswan_tpu_torch.core.grid import GridSpec
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        evaluation_report,
        predict_test_rollout,
        predict_test_set,
        save_test_results,
    )
    from nasa_niswan_tpu_torch.evalx.snapshot import load_snapshot
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device)
    snap = load_snapshot(args.run_dir, epoch=args.epoch, device=device)
    cfg, bundle, test_ds = snap.cfg, snap.bundle, snap.dataset
    params, eval_state = snap.params, snap.eval_state
    static, padded = snap.static, snap.padded_shape
    print("Number of Epochs:", snap.meta.get("epoch"))
    if (snap.closed_loop or snap.feedback_single) and (
            args.export_hidden or args.oat or args.export_artifact):
        raise SystemExit(
            "--export-hidden/--oat/--export-artifact drive the LSTM "
            "open-loop windowed/rollout paths; not available for "
            "closed-loop (seq2seq / UNet-6ch feedback) snapshots"
        )
    if not bundle.is_sequence:
        for flag, msg in ((args.export_hidden, "--export-hidden needs the LSTM family"),
                          (args.oat, "--oat drives the compiled rollout (LSTM family)"),
                          (args.export_artifact, "--export-artifact needs the LSTM family")):
            if flag:
                raise SystemExit(msg)
    if snap.closed_loop:
        from nasa_niswan_tpu_torch.evalx.evaluate import predict_test_closed_loop

        print("seq2seq snapshot: running closed-loop feedback evaluation")
        out = predict_test_closed_loop(bundle.config, params, test_ds, padded_shape=padded)
    elif snap.feedback_single:
        from nasa_niswan_tpu_torch.evalx.evaluate import predict_test_feedback

        print("6-channel feedback snapshot: running closed-loop evaluation")
        out = predict_test_feedback(bundle, params, eval_state, test_ds,
                                    padded_shape=padded)
    elif args.mode == "rollout" and bundle.is_sequence:
        out = predict_test_rollout(
            bundle.config, params, test_ds, padded_shape=padded, static=static
        )
    else:
        out = predict_test_set(
            bundle, params, eval_state, test_ds, padded_shape=padded,
            batch_size=args.batch_size, static=static,
        )
    grid_shape = tuple(out["GTs"].shape[-2:])

    if args.export_hidden:
        from nasa_niswan_tpu_torch.evalx.evaluate import predict_test_hidden

        hss = predict_test_hidden(
            bundle.config, params, test_ds, padded_shape=padded,
            batch_size=args.batch_size, static=static,
        )
        np.save(os.path.join(args.run_dir, "HSs.npy"), hss)
        print(f"HSs.npy saved: {hss.shape}")

    if args.oat:
        from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
        from nasa_niswan_tpu_torch.rollout.sensitivity import oat_sensitivity

        rollout = make_rollout_fn(
            bundle.config, test_ds.normalizer, padded_shape=padded,
            grid_shape=grid_shape, static=static,
        )
        frames, _ = test_ds.forcing_stream()
        deltas = oat_sensitivity(rollout, params, frames[None])
        np.savez_compressed(
            os.path.join(args.run_dir, "oat_sensitivity.npz"),
            **{k: v.astype(np.float32) for k, v in deltas.items()},
        )
        try:
            from nasa_niswan_tpu_torch.evalx.plots import plot_oat_boxplot

            plot_oat_boxplot(
                deltas, save_path=os.path.join(args.run_dir, "oat_boxplot.png"))
            print("oat_boxplot.png saved")
        except ImportError:
            print("matplotlib unavailable; oat_sensitivity.npz saved only")

    if args.export_artifact:
        from nasa_niswan_tpu_torch.rollout.export import export_rollout

        size = export_rollout(
            bundle.config, test_ds.normalizer, params, batch=1,
            chunk_steps=args.artifact_chunk,
            n_channels=5 if static is not None else cfg.in_channels,
            grid_shape=grid_shape, padded_shape=padded, static=static,
            path=args.export_artifact,
        )
        print(f"serving artifact: {args.export_artifact} ({size} bytes)")

    grid = GridSpec(nlat=grid_shape[0], nlon=grid_shape[1])
    report = evaluation_report(out["GTs"], out["PDs"], grid.lat, grid.lon)
    save_test_results(args.run_dir, out["GTs"], out["PDs"])
    serializable = {k: v for k, v in report.items() if not isinstance(v, np.ndarray)}
    with open(os.path.join(args.run_dir, "evaluation.json"), "w") as f:
        json.dump(serializable, f, indent=2)
    s = report["temporal_r2_summary"]
    print(
        f"temporal R2 mean/median/max: {s['mean']:.4f} / {s['median']:.4f} / "
        f"{s['max']:.4f}"
    )
    print("global R2:", f"{report['global_r2']:.4f}",
          " pearson r:", f"{report['pearson_r']:.4f}")
    return report


if __name__ == "__main__":
    main()
