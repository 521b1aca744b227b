"""Benchmark of nasa_niswan_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json`` once; README.md says how the
cells, configurations, traffic mixes and per-layer metrics are laid out as
files.  Nothing here imports JAX or the JAX package.
"""
