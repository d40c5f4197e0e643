"""Image encoder (``gan_image_captioning_tpu/models/encoder.py``):
backbone → ``Linear(F → E)`` → ``BatchNorm1d`` with momentum 0.01 — the
reference ``Encoder`` (``generator.py:8-25``), whose ``state_dict`` names
are ``resnet.*``, ``linear.*`` and ``bn.*``.  ``--encoder-arch``: the
ResNet-18 (F = 512, under ``resnet``) or ViT-B/16 (F = 768, under
``vit``; ``models/vit.py``).

* Frozen backbone (the reference default, ``--trainable-backbone 0``): the
  backbone runs under ``torch.no_grad()`` but in the step's mode, so in a
  training step its running statistics drift exactly as the reference's
  no-grad train-mode modules do (``resnet.py:10-16``); its parameters do
  not require gradients and stay out of the optimizer.
* ``--trainable-backbone 1``: the backbone is differentiated like the head.

:func:`encode` pools the backbone (the ResNet's global average, the ViT's
CLS row); :func:`encode_with_grid` runs the backbone once for the
conditional transformer and gives both the feature grid (the ResNet's
final stage ``[B, h·w, 512]``, the ViT's patch rows ``[B, P, 768]``) and
the features of the grid's mean (JAX ``encode_with_grid``: for the ViT the
patch mean, not the CLS row).  A frozen backbone's grid carries no
gradient for either backbone.  Here the port parts from the JAX package on
purpose: its ``encode_grid`` stops the ResNet grid's gradient only, so its
loss differentiates into a frozen ViT and its optimizer, which has no
mask, updates it.  The port keeps the flag's contract for the ViT too.

:func:`project_head` runs the head alone on cached backbone features
(``--cache-features``, ``data/feature_cache.py``).  ``--encoder-init
natural`` keeps the encoder out of the init sweep (:func:`sweep_skip`).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models import resnet as resnet_lib
from gan_image_captioning_tpu_torch.models import vit as vit_lib

HEAD_BN_MOMENTUM = 0.01  # generator.py:16


class Encoder(nn.Module):
    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        D = config.gen_embed_dim
        if config.encoder_arch == "vit":
            self.vit = vit_lib.ViT(config.image_size, device, dtype)
        elif config.encoder_arch == "resnet18":
            self.resnet = resnet_lib.ResNet18(device, dtype)
        else:
            raise ValueError(f"--encoder-arch {config.encoder_arch!r}: "
                             "expected resnet18 or vit")
        self.linear = nn.utils.skip_init(nn.Linear, feature_dim(config), D,
                                         device=device, dtype=dtype)
        self.bn = resnet_lib.BatchNorm(D, HEAD_BN_MOMENTUM, device=device,
                                       dtype=dtype)
        self.backbone.requires_grad_(bool(config.trainable_backbone))

    @property
    def backbone(self) -> nn.Module:
        return self.vit if hasattr(self, "vit") else self.resnet


def feature_dim(config: Config) -> int:
    """The backbone's channels: 768 for the ViT, 512 for the ResNet-18
    (the projection's and the conditional transformer's ``ctx_proj``'s
    input width)."""
    return (vit_lib.FEATURE_DIM if config.encoder_arch == "vit"
            else resnet_lib.FEATURE_DIM)


@torch.no_grad()
def init_encoder_params(generator: torch.Generator,
                        encoder: Encoder) -> Encoder:
    """The JAX ``init_encoder_params`` distributions: the backbone's (see
    ``resnet.init_resnet18_params``), projection N(0, 1)/sqrt(512) with a
    zero bias, head BatchNorm scale 1, bias 0, running mean 0, variance 1.
    Drawn on the CPU from ``generator``."""
    if hasattr(encoder, "vit"):
        vit_lib.init_vit_params(generator, encoder.vit)
    else:
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
    """``[B, 3, S, S]`` → ``[B, E]`` features (the reference forward,
    ``generator.py:19-25``: backbone → flatten → linear → BatchNorm1d).
    In train mode every BatchNorm's running statistics move once, in
    place."""
    with _backbone_grad(config):
        if hasattr(encoder, "vit"):
            feats = vit_lib.vit(encoder.vit, images)
        else:
            feats = encoder.resnet(images, train)
    return encoder.bn(encoder.linear(feats), train)


def grid_shape(config: Config):
    """``(P, C)`` of :func:`encode_grid` at ``config.image_size``: the
    ViT's patches and 768, or the ResNet-18's final stage (conv1 and the
    max pool halve the side, then three strided stages) and 512."""
    if config.encoder_arch == "vit":
        return vit_lib.num_patches(config.image_size), vit_lib.FEATURE_DIM
    side = (config.image_size - 1) // 2 + 1           # conv1 7x7 / 2, pad 3
    for _ in range(4):                                # max pool, 3 stages
        side = (side - 1) // 2 + 1
    return side * side, resnet_lib.FEATURE_DIM


def _backbone_grad(config: Config):
    """The backbone's grad mode: the caller's under ``--trainable-backbone
    1``, else off (the frozen backbone's forward records nothing)."""
    return contextlib.nullcontext() if config.trainable_backbone \
        else torch.no_grad()


def encode_grid(encoder: Encoder, images, config: Config,
                train: bool = False):
    """The backbone's feature grid for cross-attention: ``[B, h·w, 512]``
    (the ResNet's final stage) or ``[B, P, 768]`` (the ViT's patch rows);
    without gradient unless ``--trainable-backbone 1``."""
    with _backbone_grad(config):
        if hasattr(encoder, "vit"):
            return vit_lib.vit_grid(encoder.vit, images)
        return resnet_lib.resnet18_grid(encoder.resnet, images, train)


def encode_with_grid(encoder: Encoder, images, config: Config,
                     train: bool = False):
    """One backbone pass → ``(features [B, E], grid [B, P, C])``: the
    features are the head over the grid's mean (the ResNet's global
    average pool; the ViT's patch mean; in bfloat16 reduced in float32 and
    rounded once, as ``jnp.mean`` does)."""
    grid = encode_grid(encoder, images, config, train)
    pooled = grid.to(torch.float32).mean(dim=1).to(grid.dtype)
    return encoder.bn(encoder.linear(pooled), train), grid


def project_head(encoder: Encoder, pooled, train: bool = False):
    """The trainable head alone, ``Linear(F → E)`` + ``BatchNorm1d(0.01)``
    (the JAX ``project_head``), on cached backbone features ``pooled [B,
    F]`` → ``[B, E]``: the backbone's running statistics stay as they are,
    the head's move once in train mode."""
    return encoder.bn(encoder.linear(pooled), train)


def sweep_skip(config: Config):
    """The init sweep's skip predicate for a generator: under
    ``--encoder-init natural`` every ``encoder.*`` parameter keeps its own
    initialization (the JAX ``init_generator_params``' ``_skip``); else
    None (the sweep overwrites the encoder too, the reference's parity)."""
    if config.encoder_init != "natural":
        return None
    return lambda name, _p: name.startswith("encoder.")


def bn_stats(encoder: Encoder) -> dict:
    """The encoder's running statistics by ``state_dict`` name."""
    return {k: v for k, v in encoder.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
