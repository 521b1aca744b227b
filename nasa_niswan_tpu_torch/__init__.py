"""nasa_niswan_tpu_torch: the PyTorch + CUDA (Hopper) port of nasa_niswan_tpu.

The JAX package ``nasa_niswan_tpu`` is the reference; every module here has
a counterpart there under the same path, and the tests hold the two to each
other on shared weights and inputs.  This package imports torch and numpy
and never JAX, so it runs on a machine that has no JAX installed.

Layering (bottom-up), as in the JAX package:
  core/      lat-lon grid spec + geophysical padding (cyclic lon, reflective lat)
  data/      normalization constants and preprocessing, the datasets, the
             netCDF readers and writers (with the native netCDF3 reader),
             level fusion, the host batch pipeline (pinned memory, a side
             stream), the synthetic and netCDF fixtures
  ops/       NHWC conv wrapper, the hand-written CUDA kernels (csrc/: fused
             cell forward in three modes, fused cell backward and its dW,
             data-gradient conv), their nvcc build, and the autograd
             Functions of the training routes (per-cell, whole-scan BPTT,
             whole-chunk seq2seq BPTT)
  models/    ConvLSTM (functional + nn.Module) and the model registry
  rollout/   the state-carrying autoregressive rollout (the serving mode,
             each chunk one CUDA graph replay on the card), its streaming
             step, exported artifacts and carry files, OAT sensitivity, the
             multi-tracer rollouts, the serving CLI, and seq2seq
             scheduled-sampling training (config #3)
  train/     train/eval steps, fit, checkpoints, config and the training CLI
  evalx/     the metric battery, the windowed, rollout and closed-loop
             evaluations, snapshot loading, plots and the evaluation CLI
  bridge.py  weight bridge to and from the JAX parameter tree / checkpoint

Importing the package builds nothing: the CUDA kernels are compiled at the
first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
