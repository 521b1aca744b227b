"""End-to-end walkthrough of the PyTorch port on the synthetic fixture (no
NASA data needed), the twin of examples/quickstart.py.

Covers the whole lifecycle: build data, train the ConvLSTM emulator,
evaluate the test period with the state-carrying rollout, save the test
results and two figures, and run the one-at-a-time (OAT) sensitivity.

Run (CPU example sizes; on the card drop ``--device cpu``; the figures need
matplotlib, ``--no-figures`` skips them):
    python examples/torch_quickstart.py --device cpu --outdir /tmp/niswan-quickstart
"""

import argparse
import os
import sys
import tempfile

import numpy as np

# runnable from anywhere without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                    "niswan-quickstart-torch"))
    p.add_argument("--grid", nargs=2, type=int, default=(24, 36))
    p.add_argument("--steps", type=int, default=160)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--no-figures", action="store_true",
                   help="skip the two figures (they need matplotlib)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to ask for the CPU)")
    args = p.parse_args(argv)

    from nasa_niswan_tpu_torch.core.grid import GridSpec
    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.evalx.evaluate import (
        evaluation_report,
        predict_test_rollout,
        save_test_results,
    )
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.autoregressive import make_rollout_fn
    from nasa_niswan_tpu_torch.rollout.sensitivity import oat_sensitivity
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    device = resolve_device(args.device)
    H, W = args.grid
    padded = (H + 4, W + 6)
    os.makedirs(args.outdir, exist_ok=True)

    print("== 1. data (synthetic 90-day-shaped fixture)")
    data = synthetic_e33oma_90d(T=args.steps, H=H, W=W, seed=0)

    print("== 2. train")
    cfg = TrainConfig(
        model="LSTM-quickstart", hidden_channels=(8, 8), kernel_size=(3, 3),
        num_layers=2, sequence_length=6, num_epochs=args.epochs, batch_size=8,
        input_size=padded, learning_rate=1e-2, snapshot_dir=args.outdir,
        checkpoint_every=args.epochs, device=args.device,
    )
    cfg.dump()
    bundle = build_model(cfg.model, in_channels=5, hidden_channels=cfg.hidden_channels,
                         kernel_sizes=cfg.kernel_size)
    tr = SequenceDataset(data, period="train", sequence_length=cfg.sequence_length)
    va = SequenceDataset(data, period="val", sequence_length=cfg.sequence_length)
    out = fit(bundle, tr, va, cfg, device=device)

    print("== 3. evaluate (state-carrying rollout over the test period)")
    te = SequenceDataset(data, period="test", sequence_length=cfg.sequence_length)
    res = predict_test_rollout(bundle.config, out["params"], te, padded_shape=padded)
    grid = GridSpec(nlat=H, nlon=W)
    report = evaluation_report(res["GTs"], res["PDs"], grid.lat, grid.lon)
    print("temporal R2 summary:", report["temporal_r2_summary"])
    save_test_results(args.outdir, res["GTs"], res["PDs"])
    if not args.no_figures:
        from nasa_niswan_tpu_torch.evalx.plots import plot_r2_map, qqplot

        plot_r2_map(report["spatial_r2"], grid.lat, grid.lon,
                    save_path=os.path.join(args.outdir, "spatial_r2.png"))
        qqplot(res["GTs"].ravel()[::37][:5000], res["PDs"].ravel()[::37][:5000],
               quantiles=200, save_path=os.path.join(args.outdir, "qq.png"))

    print("== 4. OAT sensitivity (which inputs move the prediction)")
    rollout = make_rollout_fn(bundle.config, te.normalizer, padded_shape=padded,
                              grid_shape=(H, W))
    frames, _ = te.forcing_stream()
    sens = oat_sensitivity(rollout, out["params"], frames[None, :64])
    for name, delta in sens.items():
        print(f"  {name:>5}: mean |dpred| = {float(np.mean(delta)):.3e}")

    print("done; artifacts in", args.outdir)
    return {"report": report, "sensitivity": {k: float(np.mean(v)) for k, v in sens.items()},
            "logger": out["logger"]}


if __name__ == "__main__":
    main()
