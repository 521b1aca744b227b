#!/bin/bash
# Canonical training run on the PyTorch port (the twin of
# scripts/launch_canonical.sh; the reference launcher.sh configuration:
# LSTM 64K5.32K3.16K3, 8 input channels = 5 dynamic + 3 static, seq 48,
# 30 epochs, bs 8, StepLR(10, 0.9), Adam betas (0.5, 0.999), lr 1e-3,
# padded input 100x154), bf16 compute, on the card (--device cuda is the
# CLI's default; extra arguments are passed through, e.g. --device cpu).
set -euo pipefail

STAMP=$(date +%Y%m%d-%H%M)
SNAP=${SNAPSHOT_ROOT:-./snapshots}/LSTM-64K5.32K3.16K3-E33OMA-8C-BCB-${STAMP}

python -m nasa_niswan_tpu_torch.train \
    --model "LSTM-64K5.32K3.16K3-E33OMA-8C-BCB-${STAMP}" \
    --species bcb \
    --dataset E33OMA90D \
    --in-channels 8 \
    --hidden-channels 64 32 16 \
    --kernel-size 5 3 3 \
    --num-layers 3 \
    --sequence-length 48 \
    --num-epochs 30 \
    --input-size 100 154 \
    --batch-size 8 \
    --scheduler-config 10 0.9 \
    --betas 0.5 0.999 \
    --learning-rate 1.0E-03 \
    --compute-dtype bfloat16 \
    --snapshot-dir "${SNAP}" \
    "$@"
