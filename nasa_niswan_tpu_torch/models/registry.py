"""Model registry (counterpart of nasa_niswan_tpu/models/registry.py, the
LSTM family only; UNet and pix2pix are not ported yet).

Accepts the reference's encoded model-name strings (e.g.
``LSTM-64K5.32K3.16K3-E33OMA-8C-BCB-<date>``): the family is everything
before the first '-'.  ``remat`` (default True, as in the JAX package: the
whole-scan BPTT route) and ``precompute_input_conv`` (the hoisted input
conv, which takes the per-cell route) pick the training route as there
(models/convlstm.py).  The JAX package's other TPU knobs (``cell_impl``,
``bptt_fwd``, ``bptt_bwd``, unroll) have no counterpart: a CUDA tensor
always runs the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from nasa_niswan_tpu_torch.models.convlstm import (
    CellFn,
    ConvLSTMConfig,
    GradsFn,
    convlstm_apply,
    convlstm_init,
)
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
    state, x, *, training, rng)`` returns ``(out, new_state)`` (state is None
    for the stateless ConvLSTM).  ``x`` is (B, T, H, W, C).  Parameters are
    the port's tree of f32 tensors, leaves requiring grad.
    """

    family: str
    config: Any
    is_sequence: bool
    init: Callable[..., Tuple[Any, Any]]
    apply: Callable[..., Tuple[Any, Any]]


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
) -> ModelBundle:
    """``remat`` defaults True, as in the JAX package: the windowed trainer
    differentiates through the whole-scan BPTT, which stores no per-step
    residuals.  ``precompute_input_conv`` and ``cell_fn`` / ``grads_fn`` go
    to ``convlstm_apply``: the defaults dispatch by device (kernels on the
    card, plain versions on the CPU); the plain versions give the reference
    path on the card."""
    family = model_family(model_name)
    if family != "LSTM":
        raise NotImplementedError(
            f"model family {family} is not ported yet; only LSTM is"
        )
    cfg = ConvLSTMConfig(
        in_channels=in_channels,
        hidden_channels=tuple(hidden_channels),
        kernel_sizes=tuple(kernel_sizes),
        compute_dtype=compute_dtype,
        remat=remat,
    )

    def init(generator: torch.Generator, device=None):
        params = convlstm_init(generator, cfg, device=device)
        for cell in params["cells"]:
            for t in cell.values():
                t.requires_grad_(True)
        for t in params["head"].values():
            t.requires_grad_(True)
        return params, None

    def apply(params, state, x, *, training=False, rng=None):
        del state, training, rng
        return convlstm_apply(
            params, x, cfg, precompute_input_conv=precompute_input_conv,
            cell_fn=cell_fn, grads_fn=grads_fn,
        ), None

    return ModelBundle("LSTM", cfg, True, init, apply)
