"""Adversarial losses and sequence cross-entropy
(``gan_image_captioning_tpu/ops/losses.py``).

The reference's six GAN losses (``utils.py:10-53``) with the intended math
for ``hinge`` and ``tv`` (the reference calls ``nn.ReLU(...)`` /
``nn.Tanh(...)`` as functions, which raises).  Every mean is over all
logit elements, optionally weighted, as ``BCEWithLogitsLoss`` does.
"""

from __future__ import annotations

import torch

LOSS_TYPES = ("standard", "JS", "KL", "hinge", "tv", "rsgan")


def _wmean(x, weights=None):
    """Mean, or with ``weights`` (broadcast against ``x``) the weighted
    mean ``sum(x*w) / max(sum(w), 1e-8)``."""
    if weights is None:
        return x.mean()
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=x.dtype,
                                           device=x.device), x.shape)
    return (x * w).sum() / torch.clamp(w.sum(), min=1e-8)


def bce_with_logits(logits, targets, weights=None):
    """``max(x, 0) - x*z + log(1 + exp(-|x|))``, mean reduction."""
    targets = torch.as_tensor(targets, dtype=logits.dtype,
                              device=logits.device)
    per_elem = (torch.clamp(logits, min=0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    return _wmean(per_elem, weights)


def gan_losses(d_out_real, d_out_fake, g_out, loss_type: str = "standard",
               real_label: float = 1.0, weights=None):
    """``(g_loss, d_loss)`` for one of ``standard | JS | KL | hinge | tv |
    rsgan``; ``real_label < 1`` is one-sided label smoothing."""
    ones_r = torch.full_like(d_out_real, real_label)
    zeros_f = torch.zeros_like(d_out_fake)
    if loss_type == "standard":  # the non-saturating GAN loss
        d_loss = (bce_with_logits(d_out_real, ones_r, weights)
                  + bce_with_logits(d_out_fake, zeros_f, weights))
        g_loss = bce_with_logits(g_out, torch.ones_like(g_out), weights)
    elif loss_type == "JS":  # the vanilla GAN loss
        d_loss = (bce_with_logits(d_out_real, ones_r, weights)
                  + bce_with_logits(d_out_fake, zeros_f, weights))
        g_loss = -bce_with_logits(g_out, torch.zeros_like(g_out), weights)
    elif loss_type == "KL":
        d_loss = (bce_with_logits(d_out_real, ones_r, weights)
                  + bce_with_logits(d_out_fake, zeros_f, weights))
        g_loss = _wmean(-g_out, weights)
    elif loss_type == "hinge":
        d_loss = (_wmean(torch.relu(1.0 - d_out_real), weights)
                  + _wmean(torch.relu(1.0 + d_out_fake), weights))
        g_loss = -_wmean(g_out, weights)
    elif loss_type == "tv":
        d_loss = _wmean(torch.tanh(d_out_fake) - torch.tanh(d_out_real),
                        weights)
        g_loss = _wmean(-torch.tanh(g_out), weights)
    elif loss_type == "rsgan":  # relativistic standard GAN
        d_loss = bce_with_logits(d_out_real - d_out_fake,
                                 torch.ones_like(d_out_real), weights)
        g_loss = bce_with_logits(d_out_fake - d_out_real,
                                 torch.ones_like(d_out_fake), weights)
    else:
        raise NotImplementedError(
            "Divergence '%s' is not implemented" % loss_type)
    return g_loss, d_loss


def cross_entropy_loss(logits, targets, mask=None):
    """Token-level cross entropy of ``logits [B, T, V]`` against
    ``targets [B, T]``: the mean over all positions, pads included (the
    reference's objective), or with ``mask [B, T]`` the weighted mean over
    the unmasked ones."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
