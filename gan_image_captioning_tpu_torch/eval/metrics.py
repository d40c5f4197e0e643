"""Caption post-processing (``gan_image_captioning_tpu/eval/metrics.py``)."""

from __future__ import annotations

from typing import List, Sequence

from gan_image_captioning_tpu_torch.data.vocab import END, PAD, START


def strip_caption(ids: Sequence[int]) -> List[int]:
    """Cut a generated id sequence at the first ``<E>`` and drop
    ``<S>``/``<PAD>`` — the caption as a user would read it."""
    out = []
    for t in ids:
        t = int(t)
        if t == END:
            break
        if t in (START, PAD):
            continue
        out.append(t)
    return out


def ids_to_words(ids: Sequence[int], index_to_word: dict) -> List[str]:
    return [index_to_word.get(int(i), "<UNK>") for i in ids]
