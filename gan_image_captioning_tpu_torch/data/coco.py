"""MS-COCO Karpathy-split dataset (``gan_image_captioning_tpu/data/coco.py``,
its PIL route): ``{data_dir}/dataset_coco.json``, images under
``{data_dir}/{filepath}/{filename}`` and the reference-compatible pickle
cache.  Captions are tokenized to ids once, at construction.
``device_preprocess`` emits resized CHW uint8 (normalized on the device by
the ``image_norm`` kernel); otherwise normalized CHW float32.
``bpe_tokenizer`` (``--tokenizer bpe``, ``data/bpe.py``) tokenizes the
captions into GPT-2's id space (offset by the 4 specials) in place of the
word vocabulary.  The JAX package's native C++ decoder is not ported."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from gan_image_captioning_tpu_torch.data import images as images_lib
from gan_image_captioning_tpu_torch.data import vocab as vocab_lib


class CocoCaptions:
    def __init__(self, captions_path: str, image_path: str, split: str,
                 image_size: int = 256, captions_per_image: int = 5,
                 vocab_dicts: Optional[Tuple[dict, dict]] = None,
                 dataset_percent: float = 1.0, conditional: bool = True,
                 device_preprocess: bool = False, bpe_tokenizer=None):
        assert split in {"train", "val", "test"}
        self.split = split
        self.image_path = image_path
        self.image_size = image_size
        self.conditional = conditional
        self.dataset_percent = dataset_percent
        self.device_preprocess = device_preprocess
        self.bpe_tokenizer = bpe_tokenizer
        self.captions, self.word_to_index, self.index_to_word = (
            vocab_lib.build_coco_records(captions_path, image_path, split,
                                         captions_per_image, vocab_dicts))
        if bpe_tokenizer is not None:
            self.vocab_size = bpe_tokenizer.vocab_size
            self._token_ids = [
                np.asarray(bpe_tokenizer.encode(" ".join(rec["tokens"])),
                           dtype=np.int32)
                for rec in self.captions]
        else:
            self.vocab_size = len(self.word_to_index)  # tasks.py:102
            self._token_ids = [
                vocab_lib.tokens_to_ids(rec["tokens"], self.word_to_index)
                for rec in self.captions]

    def __len__(self):
        # dataset_percent truncates (tasks.py:106-108)
        return int(self.dataset_percent * len(self.captions))

    def image_key(self, index: int) -> str:
        """Grouping key for multi-reference evaluation: rows are flattened
        per caption (up to ``captions_per_image`` per image), so the file
        name says which rows share an image."""
        return self.captions[index]["filename"]

    def sample(self, index: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ids = self._token_ids[index]
        if not self.conditional:
            return ids, None
        rec = self.captions[index]
        path = os.path.join(self.image_path, rec["filepath"], rec["filename"])
        if self.device_preprocess:
            return ids, images_lib.load_resize_u8(path, self.image_size)
        return ids, images_lib.load_and_preprocess(path, self.image_size)
