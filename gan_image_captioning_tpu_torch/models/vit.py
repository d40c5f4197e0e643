"""ViT-B/16 image encoder backbone (``gan_image_captioning_tpu/models/vit.py``).

16 × 16 patches flattened in (ph, pw, C) order and embedded by one dense
layer, a CLS token, learned positions, 12 pre-LN blocks of the
transformer's :func:`~gan_image_captioning_tpu_torch.models.transformer.block_apply`
(d 768, 12 heads, tanh-GELU MLP 3072, layer norms eps 1e-5; the
self-attention is dense, as the JAX trunk calls ``block_apply`` without
``flash_causal``), then a final layer norm.  The width is fixed by the
module constants, so every ViT is ViT-B; ``image_size`` sets the patch
count, ``(S / 16)²``.

:func:`vit` gives the CLS row ``[B, 768]``, :func:`vit_grid` the patch
rows ``[B, P, 768]`` (the conditional transformer's cross-attention
context).  The parameters keep the JAX tree's names and layouts
(``patch_embed.w [768, 768]`` applied as ``x @ w + b``, ``cls [1, 1,
768]``, ``pos [P + 1, 768]``, ``blocks.{i}.…``, ``ln_f``); ViT has no
BatchNorm and no running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_image_captioning_tpu_torch.models import transformer as tf_lib
from gan_image_captioning_tpu_torch.models.discriminator import params_of

FEATURE_DIM = 768
PATCH = 16
DEPTH = 12
HEADS = 12
MLP_DIM = 3072


def num_patches(image_size: int) -> int:
    return (image_size // PATCH) ** 2


class ViT(nn.Module):
    """The JAX ``init_vit_params`` tree; parameters allocated
    uninitialized."""

    def __init__(self, image_size: int, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = tf_lib.Dense(PATCH * PATCH * 3, FEATURE_DIM, **kw)
        self.cls = tf_lib.new_param(1, 1, FEATURE_DIM, **kw)
        self.pos = tf_lib.new_param(num_patches(image_size) + 1, FEATURE_DIM,
                                    **kw)
        self.blocks = nn.ModuleList(tf_lib.Block(FEATURE_DIM, MLP_DIM, **kw)
                                    for _ in range(DEPTH))
        self.ln_f = tf_lib.LayerNorm(FEATURE_DIM, **kw)


@torch.no_grad()
def init_vit_params(generator: torch.Generator, vit_model: ViT) -> ViT:
    """The JAX distributions (drawn on the CPU from ``generator``): dense
    layers N(0, 1)/sqrt(d_in) with zero biases, CLS and positions
    N(0, 1)·0.02, layer norms 1 and 0."""
    tf_lib.init_blocks_(generator, vit_model)
    tf_lib.normal_init_(generator, vit_model.cls, 0.02)
    tf_lib.normal_init_(generator, vit_model.pos, 0.02)
    return vit_model


def _patchify(images):
    """``[B, C, H, W]`` → ``[B, P, 16·16·C]`` patches in (ph, pw, C)
    order."""
    b, c, h, w = images.shape
    gh, gw = h // PATCH, w // PATCH
    x = images.reshape(b, c, gh, PATCH, gw, PATCH)
    x = x.permute(0, 2, 4, 3, 5, 1)         # B, gh, gw, ph, pw, C
    return x.reshape(b, gh * gw, PATCH * PATCH * c)


def _trunk(vit_model, images):
    p = vit_model if isinstance(vit_model, dict) else params_of(vit_model)
    x = tf_lib.dense(p, "patch_embed", _patchify(images))
    b, n, d = x.shape
    cls = p["cls"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + p["pos"][: n + 1]
    for i in range(tf_lib.num_blocks(p)):
        x = tf_lib.block_apply(p, f"blocks.{i}", x, HEADS)
    return tf_lib.layer_norm(p, "ln_f", x)


def vit(vit_model, images):
    """``[B, 3, S, S]`` → ``[B, 768]`` CLS features."""
    return _trunk(vit_model, images)[:, 0]


def vit_grid(vit_model, images):
    """``[B, 3, S, S]`` → ``[B, P, 768]`` patch grid."""
    return _trunk(vit_model, images)[:, 1:]
