"""StyleGAN2 adversarial objectives: a frozen copy of the port's
`losses/gan.py` (reference training/loss_fullbody.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def g_nonsat_loss(fake_logits):
    """Non-saturating generator loss: mean softplus(-D(G(z)))."""
    return F.softplus(-fake_logits).mean()


def d_logistic_loss(real_logits=None, fake_logits=None):
    """Discriminator logistic loss: mean softplus(fake) for fakes plus mean
    softplus(-real) for reals; either side may be None."""
    loss = 0.0
    if fake_logits is not None:
        loss = loss + F.softplus(fake_logits).mean()
    if real_logits is not None:
        loss = loss + F.softplus(-real_logits).mean()
    return loss


def r1_penalty(d_apply, real_img):
    """R1 gradient penalty: mean over the batch of the sum of squares of
    d D(real) / d real, with a graph for the parameters' backward (the
    gamma/2 scaling is the caller's). d_apply: img -> logits."""
    real_img = real_img.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(real_img).sum(), real_img,
                                   create_graph=True)
    return grads.square().sum(dim=(1, 2, 3)).mean()
