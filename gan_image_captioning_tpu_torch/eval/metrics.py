"""Caption post-processing and BLEU assembly
(``gan_image_captioning_tpu/eval/metrics.py``): host-side Python over
decoded id arrays."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

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


def text_vocab(dataset):
    """What turns ``dataset``'s ids into text: its ``BPETokenizer`` under
    ``--tokenizer bpe``, else its ``index_to_word``."""
    return getattr(dataset, "bpe_tokenizer", None) or dataset.index_to_word


def caption_text(ids: Sequence[int], vocab) -> str:
    """The caption of ``ids`` (:func:`strip_caption`) as text:
    ``vocab.decode`` for a ``BPETokenizer``, else its ``index_to_word``
    words joined by spaces."""
    ids = strip_caption(ids)
    if hasattr(vocab, "decode"):
        return vocab.decode(ids)
    return " ".join(ids_to_words(ids, vocab))


def bleu4_from_batches(gen_ids_batches: List[np.ndarray],
                       real_ids_batches: List[np.ndarray],
                       weights_batches: List[np.ndarray]) -> float:
    """Corpus BLEU-4 of generated vs. real captions (single reference each),
    skipping zero-weight pad rows."""
    from gan_image_captioning_tpu_torch.eval.bleu import corpus_bleu

    cands, refs = [], []
    for gen_ids, real_ids, w in zip(gen_ids_batches, real_ids_batches,
                                    weights_batches):
        for i in range(gen_ids.shape[0]):
            if w is not None and w[i] == 0:
                continue
            cands.append(strip_caption(gen_ids[i]))
            refs.append([strip_caption(real_ids[i])])
    if not cands:
        return 0.0
    return corpus_bleu(cands, refs, max_n=4)
