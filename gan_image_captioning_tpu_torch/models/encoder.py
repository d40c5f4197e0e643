"""Image encoder (``gan_image_captioning_tpu/models/encoder.py``, its
ResNet-18 branch): backbone → ``Linear(512 → E)`` → ``BatchNorm1d`` with
momentum 0.01 — the reference ``Encoder`` (``generator.py:8-25``), whose
``state_dict`` names are ``resnet.*``, ``linear.*`` and ``bn.*``.

* Frozen backbone (the reference default, ``--trainable-backbone 0``): the
  backbone runs under ``torch.no_grad()`` but in the step's mode, so in a
  training step its running statistics drift exactly as the reference's
  no-grad train-mode modules do (``resnet.py:10-16``); its parameters do
  not require gradients and stay out of the optimizer.
* ``--trainable-backbone 1``: the backbone is differentiated like the head.

The cached-feature head (``project_head``, ``--cache-features``) and the
feature grid of the transformer family (``encode_grid``) are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models import resnet as resnet_lib

HEAD_BN_MOMENTUM = 0.01  # generator.py:16


class Encoder(nn.Module):
    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        if config.encoder_arch != "resnet18":
            raise NotImplementedError(
                f"--encoder-arch {config.encoder_arch}: only the ResNet-18 "
                "encoder is ported yet")
        D = config.gen_embed_dim
        self.resnet = resnet_lib.ResNet18(device, dtype)
        self.linear = nn.utils.skip_init(nn.Linear, resnet_lib.FEATURE_DIM, D,
                                         device=device, dtype=dtype)
        self.bn = resnet_lib.BatchNorm(D, HEAD_BN_MOMENTUM, device=device,
                                       dtype=dtype)
        self.resnet.requires_grad_(bool(config.trainable_backbone))


@torch.no_grad()
def init_encoder_params(generator: torch.Generator,
                        encoder: Encoder) -> Encoder:
    """The JAX ``init_encoder_params`` distributions: the backbone's (see
    ``resnet.init_resnet18_params``), projection N(0, 1)/sqrt(512) with a
    zero bias, head BatchNorm scale 1, bias 0, running mean 0, variance 1.
    Drawn on the CPU from ``generator``."""
    resnet_lib.init_resnet18_params(generator, encoder.resnet)
    w = encoder.linear.weight
    w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype)
            / math.sqrt(w.shape[1]))
    encoder.linear.bias.zero_()
    encoder.bn.weight.fill_(1.0)
    encoder.bn.bias.zero_()
    encoder.bn.running_mean.zero_()
    encoder.bn.running_var.fill_(1.0)
    return encoder


def encode(encoder: Encoder, images, config: Config, train: bool = False):
    """``[B, 3, S, S]`` float32 → ``[B, E]`` features (the reference
    forward, ``generator.py:19-25``: backbone → flatten → linear →
    BatchNorm1d).  In train mode every BatchNorm's running statistics
    move once, in place."""
    if config.trainable_backbone:
        feats = encoder.resnet(images, train)
    else:
        with torch.no_grad():
            feats = encoder.resnet(images, train)
    return encoder.bn(encoder.linear(feats), train)


def bn_stats(encoder: Encoder) -> dict:
    """The encoder's running statistics by ``state_dict`` name."""
    return {k: v for k, v in encoder.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
