"""Deployment-side serving with the PyTorch port, the twin of
examples/serving.py: train -> export one frozen artifact -> serve chunks
with a carried state (nothing of the model code is needed at load time
beyond the port's export loader).

Run (CPU example sizes; on the card drop ``--device cpu``, and the
artifact serves there as one CUDA graph replay per chunk):
    python examples/torch_serving.py --device cpu --outdir /tmp/niswan-serving
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                    "niswan-serving-torch"))
    p.add_argument("--grid", nargs=2, type=int, default=(24, 36))
    p.add_argument("--steps", type=int, default=160)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to ask for the CPU)")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    H, W = args.grid
    padded = (H + 8, W + 8)

    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.registry import build_model
    from nasa_niswan_tpu_torch.rollout.export import (
        export_rollout,
        initial_rollout_state,
        load_rollout,
    )
    from nasa_niswan_tpu_torch.train.__main__ import resolve_device
    from nasa_niswan_tpu_torch.train.config import TrainConfig
    from nasa_niswan_tpu_torch.train.loop import fit

    device = resolve_device(args.device)

    # 1. train (tiny, fixture-backed)
    data = synthetic_e33oma_90d(T=args.steps, H=H, W=W, seed=0)

    def mk(period):
        return SequenceDataset(data, period=period, sequence_length=6, species="bcb")

    train_ds, val_ds, test_ds = mk("train"), mk("val"), mk("test")
    cfg = TrainConfig(
        model="LSTM-serve-demo", species="bcb", in_channels=5, num_layers=2,
        hidden_channels=(8, 8), kernel_size=(5, 3), sequence_length=6,
        num_epochs=args.epochs, batch_size=4, input_size=padded,
        snapshot_dir=os.path.join(args.outdir, "run"), checkpoint_every=args.epochs,
        device=args.device,
    )
    bundle = build_model(cfg.model, in_channels=5, hidden_channels=cfg.hidden_channels,
                         kernel_sizes=cfg.kernel_size)
    cfg.dump()
    out = fit(bundle, train_ds, val_ds, cfg, device=device)

    # 2. freeze: the weights, the normalization and the rollout program in
    # one .pt2 file (torch.export), for the device it was exported on
    artifact = os.path.join(args.outdir, "emulator.pt2")
    chunk = 8
    export_rollout(
        bundle.config, train_ds.normalizer, out["params"],
        batch=1, chunk_steps=chunk, n_channels=5,
        grid_shape=(H, W), padded_shape=padded, path=artifact,
    )
    print("artifact:", artifact, os.path.getsize(artifact), "bytes")

    # 3. serve: load WITHOUT the training code path; stream chunks and
    # carry the state, the in-line ModelE-surrogate loop
    serve = load_rollout(artifact)
    frames, _ = test_ds.forcing_stream()
    state = initial_rollout_state(bundle.config, 1, padded, device)
    preds = []
    usable = frames.shape[0] - frames.shape[0] % chunk
    for s in range(0, usable, chunk):
        p_chunk, state = serve(frames[None, s:s + chunk], state)
        preds.append(p_chunk[0])
    preds = np.concatenate([p.cpu().numpy() for p in preds])
    print(f"served {preds.shape[0]} steps; pred field mean "
          f"{preds.mean():.4f} (physical units)")
    return {"artifact": artifact, "preds": preds, "params": out["params"],
            "normalizer": train_ds.normalizer, "frames": frames[:usable],
            "config": bundle.config, "padded": padded}


if __name__ == "__main__":
    main()
