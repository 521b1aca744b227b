"""nasa_niswan_tpu_torch: the PyTorch + CUDA (Hopper) port of nasa_niswan_tpu.

The JAX package ``nasa_niswan_tpu`` is the reference; every module here has
a counterpart there under the same path, and the tests hold the two to each
other on shared weights and inputs.  This package imports torch and numpy
and never JAX, so it runs on a machine that has no JAX installed.

Layering (bottom-up), as in the JAX package:
  core/      lat-lon grid spec + geophysical padding (cyclic lon, reflective lat)
  data/      normalization constants (Normalizer, zscore_static)
  ops/       NHWC conv wrapper, the hand-written CUDA fused ConvLSTM cell
             (csrc/convlstm_cell.cu) and its nvcc build
  models/    ConvLSTM forward (functional + nn.Module)
  rollout/   the state-carrying autoregressive rollout (the serving mode)
  bridge.py  weight bridge to and from the JAX parameter tree / checkpoint

Importing the package builds nothing: the CUDA kernel is compiled at its
first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
