"""Deterministic synthetic captioning fixture
(``gan_image_captioning_tpu/data/synthetic.py``): captions like "a red cat
sits on the mat" from a small grammar, with procedural images whose colour
and bright square encode the caption.  Seeded exactly as the JAX package
seeds it, so both give the same captions and images."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gan_image_captioning_tpu_torch.data.vocab import SPECIAL_TOKENS

_COLORS = ["red", "green", "blue", "yellow", "purple", "orange"]
_OBJECTS = ["cat", "dog", "ball", "car", "tree", "house", "bird", "boat"]
_VERBS = ["sits", "stands", "runs", "rests"]
_PLACES = ["mat", "road", "field", "roof", "lake", "garden"]
_FILLER = ["a", "the", "on", "near", "beside", "small", "big"]

_COLOR_RGB = {
    "red": (0.9, 0.1, 0.1), "green": (0.1, 0.8, 0.2), "blue": (0.1, 0.2, 0.9),
    "yellow": (0.9, 0.9, 0.1), "purple": (0.6, 0.1, 0.8),
    "orange": (0.95, 0.55, 0.1),
}


def synthetic_vocab():
    words = list(SPECIAL_TOKENS) + _FILLER + _COLORS + _OBJECTS + _VERBS + _PLACES
    w2i = {w: i for i, w in enumerate(words)}
    i2w = {i: w for i, w in enumerate(words)}
    return w2i, i2w


class SyntheticCaptions:
    """``sample(i) -> (token_ids, image [3, S, S] float32 | None)``, the
    same for the same ``(split, seed, i)``."""

    def __init__(self, split: str = "train", num_items: int = 256,
                 image_size: int = 64, conditional: bool = False,
                 seed: int = 1008):
        self.split = split
        self.num_items = num_items
        self.image_size = image_size
        self.conditional = conditional
        # distinct streams per split
        self.seed = seed + {"train": 0, "val": 7919, "test": 104729}[split]
        self.word_to_index, self.index_to_word = synthetic_vocab()
        self.vocab_size = len(self.word_to_index)

    def __len__(self):
        return self.num_items

    def _caption_words(self, rng) -> Tuple[list, str]:
        color = _COLORS[rng.integers(len(_COLORS))]
        obj = _OBJECTS[rng.integers(len(_OBJECTS))]
        verb = _VERBS[rng.integers(len(_VERBS))]
        place = _PLACES[rng.integers(len(_PLACES))]
        return ["a", color, obj, verb, "on", "the", place], color

    def _image(self, rng, color: str) -> np.ndarray:
        s = self.image_size
        base = rng.normal(0.0, 0.05, size=(3, s, s)).astype(np.float32)
        r, g, b = _COLOR_RGB[color]
        base[0] += r
        base[1] += g
        base[2] += b
        # a bright square whose position varies per item
        x0 = int(rng.integers(0, s // 2))
        y0 = int(rng.integers(0, s // 2))
        base[:, y0: y0 + s // 4, x0: x0 + s // 4] += 0.5
        return base

    def image_key(self, index: int) -> str:
        """One caption per synthetic item — every row is its own image."""
        return str(index)

    def sample(self, index: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        words, color = self._caption_words(rng)
        ids = np.asarray([self.word_to_index[w] for w in words], np.int32)
        image = self._image(rng, color) if self.conditional else None
        return ids, image
