"""One-at-a-time (OAT) sensitivity analysis (counterpart of
nasa_niswan_tpu/rollout/sensitivity.py; reference: test.ipynb cells
56-57): perturb each input channel by a multiplicative factor, re-run the
rollout, and measure the prediction deltas per channel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


def oat_sensitivity(
    rollout: Callable,
    params,
    forcings,
    *,
    channels: Optional[Sequence[int]] = None,
    factor: float = 1.05,
    channel_names: Sequence[str] = ("u", "v", "w", "prec", "src"),
    batched: bool = False,
) -> Dict[str, np.ndarray]:
    """Returns {channel_name: |pred_perturbed - pred_base| (B, T, h, w)}.

    ``rollout(params, forcings) -> (preds, state)`` as built by
    ``make_rollout_fn``; ``forcings`` raw (B, T, C, H, W), tensor or numpy;
    ``factor`` is the reference's 1 + 0.05 perturbation.  ``batched=True``
    folds the base pass and every perturbation into the batch axis of one
    rollout call (B must be 1): one graph replay for the whole sweep.
    """
    forcings = torch.as_tensor(forcings)
    if channels is None:
        channels = range(min(forcings.shape[2], len(channel_names)))
    channels = list(channels)

    def perturbed(ci):
        x = forcings.clone()
        x[:, :, ci] *= factor
        return x

    if batched:
        if forcings.shape[0] != 1:
            raise ValueError(
                f"batched OAT folds variants into the batch axis; input must "
                f"have B == 1, got B={forcings.shape[0]}"
            )
        variants = torch.cat([forcings] + [perturbed(ci) for ci in channels])
        preds, _ = rollout(params, variants)
        preds = preds.cpu().numpy()
        return {
            channel_names[ci]: np.abs(preds[i + 1 : i + 2] - preds[:1])
            for i, ci in enumerate(channels)
        }
    base, _ = rollout(params, forcings)
    base = base.cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for ci in channels:
        pred, _ = rollout(params, perturbed(ci))
        out[channel_names[ci]] = np.abs(pred.cpu().numpy() - base)
    return out
