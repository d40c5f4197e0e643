"""Fixed-shape batches (``gan_image_captioning_tpu/data/loader.py``).

Every batch is padded to the same width ``seq_len = max_seq_len + 2``:
captions wrapped ``<S> tokens… <E>`` then ``<PAD>``-padded, and a final
partial batch padded with zero-weighted rows.  :class:`Batcher` iterates a
dataset in the JAX ``Batcher``'s order (the same seeded shuffle, so the
same batches); it builds them in the caller's thread.  Precollation,
length buckets and host sharding are not ported (``--precollate``,
``--length-buckets`` and ``--mesh`` raise).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from gan_image_captioning_tpu_torch.data.vocab import END, PAD, START


def make_batch(captions_list, images_list, seq_len: int,
               batch_size: Optional[int] = None):
    """One batch dict of numpy arrays: ``captions [B, seq_len]`` int32,
    ``lengths [B]`` int32, ``weights [B]`` float32 (0 on pad rows).

    ``captions_list``: 1-D int arrays (token ids, no specials), truncated
    to ``seq_len - 2``.  ``images_list``: None (unconditional), or one
    array per row: ``[3, S, S]`` float32 → ``images``, ``[3, S, S]`` uint8
    → ``images_u8`` (normalized on the device), ``[512]`` → cached
    ``backbone_feats`` (which the port's steps refuse: ``--cache-features``
    is not ported).  Pad rows get zero images."""
    n = len(captions_list)
    batch_size = batch_size or n
    captions = np.full((batch_size, seq_len), PAD, dtype=np.int32)
    lengths = np.zeros((batch_size,), np.int32)
    weights = np.zeros((batch_size,), np.float32)
    for i, toks in enumerate(captions_list):
        toks = np.asarray(toks, np.int32)[: seq_len - 2]
        captions[i, 0] = START
        captions[i, 1: 1 + len(toks)] = toks
        captions[i, 1 + len(toks)] = END
        lengths[i] = len(toks) + 2
        weights[i] = 1.0
    batch = {"captions": captions, "lengths": lengths, "weights": weights}
    if images_list is not None and images_list[0] is not None:
        img_shape = images_list[0].shape
        dtype = np.asarray(images_list[0]).dtype
        images = np.zeros((batch_size,) + img_shape, dtype)
        for i, im in enumerate(images_list):
            images[i] = im
        if len(img_shape) == 1:
            batch["backbone_feats"] = images
        elif dtype == np.uint8:
            batch["images_u8"] = images
        else:
            batch["images"] = images
    return batch


class Batcher:
    """Iterable over fixed-shape batches of ``dataset`` (``__len__`` and
    ``sample(i) -> (token_ids, image_or_None)``).

    Each iteration is one epoch: the order is ``arange(n)``, shuffled by
    ``numpy.random.default_rng(seed + epoch)`` when ``shuffle``, cut into
    ``batch_size`` slices (the last one dropped under ``drop_last``,
    else padded with zero-weighted rows), and
    ``epoch`` counts the iterations started.  Each batch also carries
    ``index [B]``, the dataset row of each batch row (pad rows repeat the
    first)."""

    def __init__(self, dataset, batch_size: int, seq_len: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start: start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield idx

    def _build(self, idx):
        samples = [self.dataset.sample(int(i)) for i in idx]
        caps = [s[0] for s in samples]
        imgs = [s[1] for s in samples]
        batch = make_batch(caps, None if imgs[0] is None else imgs,
                           self.seq_len, self.batch_size)
        index = np.full((batch["captions"].shape[0],), int(idx[0]), np.int32)
        index[: len(idx)] = idx
        batch["index"] = index
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """This epoch's batches from batch ``start_batch`` on: the order is
        built in full (the same shuffle as a whole epoch), and the skipped
        batches are not built."""
        batches = list(self._index_batches())[start_batch:]
        self.epoch += 1
        for idx in batches:
            yield self._build(idx)
