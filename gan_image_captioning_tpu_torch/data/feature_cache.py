"""Frozen-backbone feature caching
(``gan_image_captioning_tpu/data/feature_cache.py``, ``--cache-features``).

The reference runs the frozen backbone on every image every epoch; its
output never changes when the backbone is frozen, so here the pooled
backbone features are computed once per image, in batches on the model's
device (the backbone's BatchNorms in eval mode: the running statistics),
and the training batches carry ``backbone_feats [B, F]`` in place of the
images (``data/loader.make_batch``), which only the trainable head
(``encoder.project_head``) reads.

Semantics, as in the JAX package: caching fixes the backbone's BatchNorms
in eval mode, where the reference's run in train mode and drift batch to
batch, so the flag is opt-in; augmentation does not reach cached
features.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gan_image_captioning_tpu_torch.kernels.image_norm import (
    normalize_images)
from gan_image_captioning_tpu_torch.models import vit as vit_lib


@torch.no_grad()
def precompute_backbone_features(dataset, encoder, batch_size: int = 32
                                 ) -> np.ndarray:
    """``[N, F]`` float32 pooled backbone outputs (eval-mode BatchNorm) of
    every image of ``dataset``, in batches of ``batch_size`` on
    ``encoder``'s device; uint8 images are normalized first (the
    ``image_norm`` kernel on the card, its plain version on the CPU)."""
    backbone = encoder.backbone
    device = next(backbone.parameters()).device
    out = []
    for start in range(0, len(dataset), batch_size):
        imgs = []
        for i in range(start, min(start + batch_size, len(dataset))):
            _, img = dataset.sample(i)
            if img is None:
                raise ValueError("feature caching needs a conditional "
                                 "dataset")
            imgs.append(img)
        batch = torch.from_numpy(np.stack(imgs)).to(device)
        if batch.dtype == torch.uint8:
            batch = normalize_images(batch, torch.float32)
        if hasattr(encoder, "vit"):
            feats = vit_lib.vit(encoder.vit, batch)
        else:
            feats = encoder.resnet(batch, False)
        out.append(feats.to(torch.float32).cpu().numpy())
    return np.concatenate(out)


class CachedFeatureDataset:
    """A conditional dataset whose samples carry the cached backbone
    features in place of the images; the vocabulary and caption interface
    of ``base`` stay."""

    def __init__(self, base, features: np.ndarray):
        if len(base) != len(features):
            raise ValueError(f"{len(features)} cached features for a "
                             f"dataset of {len(base)} items")
        self.base = base
        self.features = features
        self.word_to_index = base.word_to_index
        self.index_to_word = base.index_to_word
        self.vocab_size = base.vocab_size

    def __len__(self):
        return len(self.base)

    def caption_length(self, i: int) -> int:
        get = getattr(self.base, "caption_length", None)
        return get(i) if get else len(self.caption_ids(i))

    def caption_ids(self, i: int) -> np.ndarray:
        get = getattr(self.base, "caption_ids", None)
        return get(i) if get else self.base.sample(i)[0]

    def image_key(self, i: int) -> str:
        """The base dataset's grouping key, so that ``--scst-multi-ref``
        keeps working under ``--cache-features``."""
        key_of = getattr(self.base, "image_key", None)
        return key_of(i) if key_of else str(i)

    def sample(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.caption_ids(i), self.features[i]
