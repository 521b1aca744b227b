"""Adversarial pix2pix training (counterpart of nasa_niswan_tpu/train/gan.py):
the conditional-GAN objective, one step updating both networks.

G loss = BCE(D(G(x), x_cond), 1) + lambda_l1 * L1(y, G(x))
D loss = 0.5 * [BCE(D(y, x_cond), 1) + BCE(D(G(x), x_cond), 0)]

``x_cond`` is the first ``d_cfg.in_channels`` channels of x.  The order of
work is the JAX package's: D's loss takes its own generator forward (a
detached fake), D is updated first, then G's loss runs a second generator
forward (its own dropout draw) through the updated D.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nasa_niswan_tpu_torch.bridge import tree_leaves
from nasa_niswan_tpu_torch.models.pix2pix import (
    DiscriminatorConfig,
    GeneratorConfig,
    discriminator_apply,
    generator_apply,
)


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits (torch BCEWithLogitsLoss), in
    the JAX package's form."""
    t = torch.full_like(logits, target)
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    )


def make_gan_train_step(
    g_cfg: GeneratorConfig,
    d_cfg: DiscriminatorConfig,
    g_optimizer: torch.optim.Optimizer,
    d_optimizer: torch.optim.Optimizer,
    *,
    lambda_l1: float = 100.0,
) -> Callable:
    """``step(g_params, d_params, x, y, generator=None) -> {g_loss, d_loss,
    l1}``: one update of each network, in place, by its optimizer (Adams
    over ``bridge.tree_leaves`` of each tree, as ``train.loop.make_optimizer``
    builds them).  x and y are NHWC on one device, y with the
    discriminator's in_channels; ``generator`` (on that device) draws both
    generator forwards' dropout.  The losses come back as device
    scalars."""
    del g_cfg

    def y_cond(x):
        return x[..., : d_cfg.in_channels]

    def step(g_params, d_params, x, y, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():  # D's loss sees a detached fake
            fake = generator_apply(g_params, x, training=True, generator=generator)
        real_logits = discriminator_apply(d_params, y, y_cond(x), d_cfg)
        fake_logits = discriminator_apply(d_params, fake, y_cond(x), d_cfg)
        d_loss = 0.5 * (bce_with_logits(real_logits, 1.0)
                        + bce_with_logits(fake_logits, 0.0))
        d_optimizer.zero_grad(set_to_none=True)
        d_loss.backward(inputs=tree_leaves(d_params))
        d_optimizer.step()

        fake = generator_apply(g_params, x, training=True, generator=generator)
        adv = bce_with_logits(discriminator_apply(d_params, fake, y_cond(x), d_cfg), 1.0)
        l1 = torch.mean(torch.abs(y - fake))
        g_loss = adv + lambda_l1 * l1
        g_optimizer.zero_grad(set_to_none=True)
        g_loss.backward(inputs=tree_leaves(g_params))
        g_optimizer.step()
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(), "l1": l1.detach()}

    return step
