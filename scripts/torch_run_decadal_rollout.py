#!/usr/bin/env python3
"""The config #5 headline on the port, the twin of
scripts/run_decadal_rollout.py: a decadal multi-tracer rollout.

    python scripts/torch_run_decadal_rollout.py [--ckpt-root DIR] [--years 10]
        [--year-steps 17520] [--chunk 1752] [--sharded LAT LON] [--device cuda]

Serves three tracers (BCB, sea salt, clay) through the shared-meteorology
multi-tracer rollout over ``--years`` model years of ``--year-steps``
half-hour steps, one carried state and no resets.  The forcing year (a
fresh synthetic realization, seed 23) is uploaded to the device once and
cycled; the ground truth stays there in bf16.  The emulators are the
checkpoints scripts/torch_run_multitracer_demo.py wrote under
``<ckpt-root>/run_{species}/epoch-NNN`` (trained on another realization),
so year 1's skill is out-of-realization, and the skill per year shows
whether a decade of feedback through the carry degrades it.  Each chunk is
one CUDA graph replay on a card (a last chunk of another length is a
second capture); its R^2 terms stay on the device and are fetched once a
year.

``--sharded LAT LON`` cuts the padded grid into LAT x LON tiles over as
many ranks (``parallel/launch.spawn``: one card each, or CPU processes with
``--device cpu``) and serves through
``parallel/spatial.make_sharded_multitracer_rollout_shared``, config #5's
whole composition; rank 0 writes.  Writes ``<out>/results_decadal.json``:
per-year R^2 by species, the sustained species-days/min, and the RMS of
layer 1's carried h at the end of each year.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SPECIES = ("bcb", "seasalt", "clay")
HIDDEN, KERNELS = (64, 32, 16), (5, 3, 3)
GRID, PADDED = (90, 144), (100, 154)
SEQ = 48
_TMP = tempfile.gettempdir()


def _sizes() -> dict:
    """The widths, handed to each spawned rank (which imports this module
    anew)."""
    return dict(hidden=HIDDEN, kernels=KERNELS, grid=GRID, padded=PADDED, seq=SEQ)


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-root", default=os.path.join(_TMP, "multitracer_demo_torch"))
    ap.add_argument("--train-steps", type=int, default=1440,
                    help="fixture length the checkpoints were trained on")
    ap.add_argument("--train-seed", type=int, default=11)
    ap.add_argument("--year-steps", type=int, default=17520)
    ap.add_argument("--year-seed", type=int, default=23)
    ap.add_argument("--years", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=1752)
    ap.add_argument("--epochs", type=int, default=8,
                    help="epoch number of the checkpoint to load")
    ap.add_argument("--out", default=os.path.join(_TMP, "decadal_demo_torch"))
    ap.add_argument("--sharded", nargs=2, type=int, metavar=("LAT", "LON"), default=None,
                    help="shard the padded grid over a (lat, lon) mesh of LAT*LON "
                         "ranks, one device each (default: one device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to ask for the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    os.makedirs(args.out, exist_ok=True)
    import torch

    if args.sharded:
        from nasa_niswan_tpu_torch.parallel import launch

        lat, lon = args.sharded
        device_type = torch.device(args.device).type
        result = launch.spawn(_serve_rank, lat * lon, device_type, vars(args), _sizes())[0]
    else:
        from nasa_niswan_tpu_torch.train.__main__ import resolve_device

        result = serve(args, resolve_device(args.device), None, _sizes())
    print(json.dumps(result, indent=2), flush=True)
    with open(os.path.join(args.out, "results_decadal.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def _serve_rank(rank: int, args: dict, sizes: dict):
    from nasa_niswan_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, *args["sharded"])
    return serve(argparse.Namespace(**args), mesh.device, mesh, sizes)


def serve(args, device, mesh, sizes: dict) -> dict:
    """The decade on ``device``, sharded over ``mesh`` when given (every
    rank calls it and returns the same result)."""
    import torch

    from nasa_niswan_tpu_torch.data.dataset import SequenceDataset
    from nasa_niswan_tpu_torch.data.synthetic import synthetic_e33oma_90d
    from nasa_niswan_tpu_torch.models.convlstm import ConvLSTMConfig, convlstm_init
    from nasa_niswan_tpu_torch.rollout.autoregressive import model_days_per_min
    from nasa_niswan_tpu_torch.rollout.multitracer import (
        make_multitracer_rollout_shared,
        stack_params,
    )
    from nasa_niswan_tpu_torch.train.checkpoint import load_checkpoint

    grid, padded = tuple(sizes["grid"]), tuple(sizes["padded"])
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device: {name}", flush=True)
    # the normalizers, rebuilt from the training realization (exact)
    t0 = time.time()
    train_data = synthetic_e33oma_90d(T=args.train_steps, seed=args.train_seed,
                                      species=SPECIES, H=grid[0], W=grid[1])
    norms = [SequenceDataset(train_data, period="train", sequence_length=sizes["seq"],
                             species=sp, in_channels=5).normalizer for sp in SPECIES]
    say(f"normalizers rebuilt: {time.time() - t0:.0f}s", flush=True)

    cfg = ConvLSTMConfig(in_channels=5, hidden_channels=tuple(sizes["hidden"]),
                         kernel_sizes=tuple(sizes["kernels"]), compute_dtype="bfloat16")
    template = convlstm_init(torch.Generator().manual_seed(0), cfg, device=device)
    params_list = []
    for sp in SPECIES:
        ckpt = os.path.join(args.ckpt_root, f"run_{sp}", f"epoch-{args.epochs:03d}")
        if not os.path.isdir(ckpt):
            raise SystemExit(
                f"no checkpoint at {ckpt}: train the per-species emulators first:\n"
                f"  python scripts/torch_run_multitracer_demo.py --epochs {args.epochs} "
                f"--out {args.ckpt_root}")
        params, _, _ = load_checkpoint(ckpt, template)
        params_list.append(params)
    with torch.no_grad():
        stacked = stack_params(params_list)
    if mesh is not None:
        from nasa_niswan_tpu_torch.parallel.spatial import (
            gather_state,
            make_sharded_multitracer_rollout_shared,
        )

        say(f"sharded serving mesh: lat={mesh.lat} lon={mesh.lon}", flush=True)
        rollout = make_sharded_multitracer_rollout_shared(cfg, norms, mesh,
                                                          padded_shape=padded,
                                                          grid_shape=grid)
    else:
        rollout = make_multitracer_rollout_shared(cfg, norms, padded_shape=padded,
                                                  grid_shape=grid)

    # the serving year: a fresh realization of the same climate
    t0 = time.time()
    year = synthetic_e33oma_90d(T=args.year_steps, seed=args.year_seed, species=SPECIES,
                                H=grid[0], W=grid[1])
    say(f"serving-year fixture: {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    met_dev = torch.as_tensor(np.stack([year[k] for k in ("u", "v", "omega", "prec")],
                                       axis=1), device=device)  # (T, 4, H, W)
    emis_dev = torch.as_tensor(np.stack([year[f"{sp}_src"] for sp in SPECIES]),
                               device=device)  # (S, T, H, W)
    # the ground truth in bf16 (half the memory; R^2 to ~3 decimals)
    gt_dev = torch.as_tensor(np.stack([year[f"{sp}_conc"] for sp in SPECIES]),
                             device=device).to(torch.bfloat16)  # (S, T, h, w)
    del year
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"device upload: {time.time() - t0:.0f}s", flush=True)

    T = args.year_steps
    state, yearly, state_norms, total_steps = None, [], [], 0
    t_serve = time.time()
    with torch.inference_mode():
        for yr in range(args.years):
            res_terms, tot_terms = [], []
            for s in range(0, T, args.chunk):
                m = met_dev[s:s + args.chunk][None]
                e = emis_dev[:, None, s:s + args.chunk]
                p, state = rollout(stacked, m, e, state)
                # per-step residual and total sums over the grid, on the
                # device (against each step's spatial mean, as
                # evalx.metrics.r2_temporal); fetched once a year
                y = gt_dev[:, s:s + args.chunk].float()
                res_terms.append(((y - p[:, 0]) ** 2).sum(dim=(-2, -1)))
                tot_terms.append(((y - y.mean(dim=(-2, -1), keepdim=True)) ** 2)
                                 .sum(dim=(-2, -1)))
                total_steps += m.shape[1]
            r2_t = 1.0 - (torch.cat(res_terms, dim=1) / torch.cat(tot_terms, dim=1))
            r2_t = r2_t.cpu().numpy()  # (S, T)
            r2 = {sp: float(np.nanmean(r2_t[i])) for i, sp in enumerate(SPECIES)}
            carry = state if mesh is None else gather_state(state, mesh, batch_axis=1)
            h1 = carry[0][0].float()
            h_norm = float(torch.sqrt(torch.mean(h1 * h1)))
            state_norms.append(h_norm)
            yearly.append(r2)
            say(f"year {yr + 1}: R2 {r2}  |h1|_rms {h_norm:.4f}", flush=True)
    elapsed = time.time() - t_serve

    return {
        "config": "decadal 3-species shared-met rollout, one carried state",
        "years": args.years,
        "total_steps": int(total_steps),
        "serving_wall_s": round(elapsed, 1),
        "aggregate_species_days_per_min": round(
            model_days_per_min(total_steps, elapsed, batch=len(SPECIES)), 1),
        "per_year_r2": yearly,
        "layer1_h_rms_by_year": [round(x, 5) for x in state_norms],
        "year_steps": T,
        "chunk": args.chunk,
        "sharded": list(args.sharded) if args.sharded else None,
        "device": name,
    }


if __name__ == "__main__":
    main()
