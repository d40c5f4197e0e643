"""Fixed-shape batches (``gan_image_captioning_tpu/data/loader.py``).

Only :func:`make_batch` is ported: every batch is padded to the same width
``seq_len = max_seq_len + 2``, captions wrapped ``<S> tokens… <E>`` then
``<PAD>``-padded, and a final partial batch padded with zero-weighted rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gan_image_captioning_tpu_torch.data.vocab import END, PAD, START


def make_batch(captions_list, images_list, seq_len: int,
               batch_size: Optional[int] = None):
    """One batch dict of numpy arrays: ``captions [B, seq_len]`` int32,
    ``lengths [B]`` int32, ``weights [B]`` float32 (0 on pad rows).

    ``captions_list``: 1-D int arrays (token ids, no specials), truncated
    to ``seq_len - 2``.  ``images_list`` must be None: the conditional
    path is not ported yet."""
    if images_list is not None and images_list[0] is not None:
        raise NotImplementedError("images in a batch: the conditional "
                                  "encoder is not ported yet")
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
    return {"captions": captions, "lengths": lengths, "weights": weights}
