"""Model registry (counterpart of nasa_niswan_tpu/models/registry.py): the
ConvLSTM (LSTM), UNet and pix2pix (PIX2PIX) families.

Accepts the reference's encoded model-name strings (e.g.
``LSTM-64K5.32K3.16K3-E33OMA-8C-BCB-<date>``): the family is everything
before the first '-'.  ``remat`` (default True, as in the JAX package: the
whole-scan BPTT route) and ``precompute_input_conv`` (the hoisted input
conv, which takes the per-cell route) pick the training route as there
(models/convlstm.py).  The JAX package's other TPU knobs (``bptt_fwd``,
``bptt_bwd``, unroll) have no counterpart, and ``cell_impl`` is recorded
in the run's configuration, ignored by the port: a CUDA tensor always runs
the kernels.  UNet and PIX2PIX are single-step models
(``is_sequence=False``); as in the JAX package the PIX2PIX bundle is the
Generator alone, trained with MSE + L1 (train/gan.py trains it against the
PatchGAN).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves
from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    GradsFn,
    convlstm_apply,
    convlstm_init,
)
from nasa_niswan_tpu_torch.models.pix2pix import (
    GeneratorConfig,
    generator_apply,
    generator_init,
)
from nasa_niswan_tpu_torch.models.unet import UNetConfig, unet_apply, unet_init
from nasa_niswan_tpu_torch.ops.convgrad import cell_grads
from nasa_niswan_tpu_torch.ops.convlstm_cell import fused_cell_forward

FAMILIES = ("LSTM", "UNet", "PIX2PIX")


def model_family(model_name: str) -> str:
    """The reference's dispatch key: everything before the first '-'."""
    family = model_name.split("-")[0]
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}; expected one of {FAMILIES}")
    return family


@dataclasses.dataclass
class ModelBundle:
    """A constructed model: functional init/apply plus metadata the trainer
    needs.

    ``init(generator, device)`` returns ``(params, state)``; ``apply(params,
    state, x, *, training, rng, mesh=None)`` returns ``(out, new_state)``
    (state is None for the stateless families; the UNet's holds its
    BatchNorm statistics; ``rng`` is a ``torch.Generator`` on x's device,
    PIX2PIX's dropout).  With a ``mesh`` (parallel/mesh.py) x is this
    rank's share of a global batch, cut over dp and, with ``tiles`` (the
    spatially sharded step, parallel/spatial.py), its (lat, lon) tile, and
    so is the output: the UNet's BatchNorms take the global batch's
    statistics over the mesh and PIX2PIX draws the global batch's dropout
    masks, so the data-parallel and the spatially sharded steps equal the
    single-device step on the global batch (the UNet's new state holds the
    global running statistics, the same on every rank).  The ConvLSTM's
    ``apply`` ignores both: the spatially sharded step runs its cells on
    tiles itself.  ``x`` is (B, T, H, W, C) for sequence models and
    (B, H, W, C) otherwise.  Parameters are the port's tree of f32
    tensors, leaves requiring grad.  ``precompute_input_conv`` records
    whether the ConvLSTM hoists its input conv.
    """

    family: str
    config: Any
    is_sequence: bool
    init: Callable[..., Tuple[Any, Any]]
    apply: Callable[..., Tuple[Any, Any]]
    precompute_input_conv: bool = False


def build_model(
    model_name: str,
    *,
    in_channels: int,
    hidden_channels: Tuple[int, ...] = (64, 32, 16),
    kernel_sizes: Tuple[int, ...] = (5, 3, 3),
    compute_dtype: str = "float32",
    precompute_input_conv: bool = False,
    remat: bool = True,
    cell_fn: CellFn = fused_cell_forward,
    grads_fn: Optional[GradsFn] = cell_grads,
    unet_features: Tuple[int, ...] = (64, 128, 256, 512),
    pix2pix_features: int = 64,
) -> ModelBundle:
    """``remat`` defaults True, as in the JAX package: the windowed trainer
    differentiates through the whole-scan BPTT, which stores no per-step
    residuals.  ``precompute_input_conv`` and ``cell_fn`` / ``grads_fn`` go
    to ``convlstm_apply``: the defaults dispatch by device (kernels on the
    card, plain versions on the CPU); the plain versions give the reference
    path on the card.  ``unet_features`` and ``pix2pix_features`` size the
    single-step families."""
    family = model_family(model_name)
    if family == "UNet":
        ucfg = UNetConfig(in_channels=in_channels, features=tuple(unet_features))

        def init(generator: torch.Generator, device=None):
            params, state = unet_init(generator, ucfg, device=device)
            return _trainable(params), state

        def apply(params, state, x, *, training=False, rng=None, mesh=None, tiles=False):
            del rng
            if tiles:
                return unet_apply(params, state, x, training=training, mesh=mesh)
            group = None if mesh is None else mesh.groups["dp"]
            return unet_apply(params, state, x, training=training, group=group)

        return ModelBundle("UNet", ucfg, False, init, apply)
    if family == "PIX2PIX":
        gcfg = GeneratorConfig(in_channels=in_channels, features=pix2pix_features)

        def init(generator: torch.Generator, device=None):
            return _trainable(generator_init(generator, gcfg, device=device)), None

        def apply(params, state, x, *, training=False, rng=None, mesh=None, tiles=False):
            if tiles:
                return generator_apply(params, x, training=training, generator=rng,
                                       mesh=mesh), None
            shard = (0, 1) if mesh is None else (mesh.index("dp"), mesh.dp)
            return generator_apply(params, x, training=training, generator=rng,
                                   shard=shard), None

        return ModelBundle("PIX2PIX", gcfg, False, init, apply)

    cfg = ConvLSTMConfig(
        in_channels=in_channels,
        hidden_channels=tuple(hidden_channels),
        kernel_sizes=tuple(kernel_sizes),
        compute_dtype=compute_dtype,
        remat=remat,
    )

    def init(generator: torch.Generator, device=None):
        return _trainable(convlstm_init(generator, cfg, device=device)), None

    def apply(params, state, x, *, training=False, rng=None, mesh=None, tiles=False):
        del state, training, rng, mesh, tiles
        return convlstm_apply(
            params, x, cfg, precompute_input_conv=precompute_input_conv,
            cell_fn=cell_fn, grads_fn=grads_fn,
        ), None

    return ModelBundle("LSTM", cfg, True, init, apply, precompute_input_conv)


def _trainable(params):
    """``params`` with every leaf requiring grad."""
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params
