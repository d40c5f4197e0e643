"""Vocabulary of the synthetic captioning fixture
(``gan_image_captioning_tpu/data/synthetic.py:synthetic_vocab``)."""

from gan_image_captioning_tpu_torch.data.vocab import SPECIAL_TOKENS

_COLORS = ["red", "green", "blue", "yellow", "purple", "orange"]
_OBJECTS = ["cat", "dog", "ball", "car", "tree", "house", "bird", "boat"]
_VERBS = ["sits", "stands", "runs", "rests"]
_PLACES = ["mat", "road", "field", "roof", "lake", "garden"]
_FILLER = ["a", "the", "on", "near", "beside", "small", "big"]


def synthetic_vocab():
    words = list(SPECIAL_TOKENS) + _FILLER + _COLORS + _OBJECTS + _VERBS + _PLACES
    w2i = {w: i for i, w in enumerate(words)}
    i2w = {i: w for i, w in enumerate(words)}
    return w2i, i2w
