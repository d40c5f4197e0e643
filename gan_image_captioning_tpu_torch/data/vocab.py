"""Special tokens, vocabulary build and caption records of the Karpathy COCO
split (``gan_image_captioning_tpu/data/vocab.py``).

``build_coco_records`` reads and writes the reference-compatible pickle
cache ``{image_path}/{split}_{captions_per_image}.pkl`` (keys ``captions``
/ ``w2i`` / ``i2w``), so a data dir prepared by either package works for
both; the vocabulary grows in first-appearance order over the train
captions and is reused read-only for val/test.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

SPECIAL_TOKENS = ("<PAD>", "<S>", "<E>", "<UNK>")
PAD, START, END, UNK = 0, 1, 2, 3


def _new_vocab() -> Tuple[Dict[str, int], Dict[int, str]]:
    return ({tok: i for i, tok in enumerate(SPECIAL_TOKENS)},
            {i: tok for i, tok in enumerate(SPECIAL_TOKENS)})


def build_coco_records(captions_path: str, image_path: str, split: str,
                       captions_per_image: int = 5,
                       vocab_dicts: Optional[Tuple[dict, dict]] = None):
    """The Karpathy json → ``(captions, word_to_index, index_to_word)``:
    one record per sentence (the image's scalar fields plus the sentence's,
    ``tokens`` a list of words), rows filtered by ``split in
    row['filepath']``, the first ``captions_per_image`` sentences each."""
    assert split in {"train", "val", "test"}
    cache_file = os.path.join(image_path, f"{split}_{captions_per_image}.pkl")
    if os.path.exists(cache_file):
        with open(cache_file, "rb") as f:
            saved = pickle.load(f)
        return saved["captions"], saved["w2i"], saved["i2w"]

    with open(captions_path, "r") as f:
        rows = json.load(f)["images"]
    if vocab_dicts is None:
        word_to_index, index_to_word = _new_vocab()
        grow = True
    else:
        word_to_index, index_to_word = vocab_dicts
        grow = False

    captions: List[dict] = []
    for row in rows:
        if split not in row["filepath"]:
            continue
        scalar_fields = {k: v for k, v in row.items()
                         if not isinstance(v, list)}
        for sentence in row["sentences"][:captions_per_image]:
            record = dict(scalar_fields)
            record.update(sentence)
            captions.append(record)
            if grow:
                for word in sentence["tokens"]:
                    if word not in word_to_index:
                        idx = len(word_to_index)
                        word_to_index[word] = idx
                        index_to_word[idx] = word

    with open(cache_file, "wb") as f:
        pickle.dump({"captions": captions, "w2i": word_to_index,
                     "i2w": index_to_word}, f)
    return captions, word_to_index, index_to_word


def tokens_to_ids(tokens: List[str],
                  word_to_index: Dict[str, int]) -> np.ndarray:
    """Words → ids with the ``<UNK>`` fallback, non-destructively."""
    return np.asarray([word_to_index.get(t, UNK) for t in tokens],
                      dtype=np.int32)
