"""Corpus BLEU.

The reference imported ``torchtext``'s ``bleu_score`` but left every call
commented out (``training.py:13,75-76,155-156``); the report's BLEU-4 tables
(NLP_Report.pdf Tables 1-5) were computed offline.  Here BLEU is first-class.

Standard corpus BLEU: clipped modified n-gram precision up to ``max_n``,
uniform weights, brevity penalty — the same definition torchtext/NLTK use, so
numbers are comparable with the report.

The port's copy of ``gan_image_captioning_tpu/eval/bleu.py`` (the port
imports nothing of the JAX package): the same operations in the same
order, so the same numbers to the last bit.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(candidate: Sequence, references: List[Sequence],
                  max_n: int = 4) -> float:
    """Smoothed per-sentence BLEU-``max_n`` (SCST reward use).

    Corpus BLEU zeroes out whenever any n-gram order has no match — useless
    as a per-sample reward signal.  This applies add-one smoothing to the
    clipped counts and totals for n >= 2 (Chen & Cherry 2014, method 1),
    keeping 1-gram precision exact; brevity penalty as in corpus BLEU.
    """
    cand = list(candidate)
    if not cand:
        return 0.0
    log_p = 0.0
    for n in range(1, max_n + 1):
        cand_ngrams = _ngrams(cand, n)
        max_ref: Counter = Counter()
        for ref in references:
            for gram, cnt in _ngrams(list(ref), n).items():
                max_ref[gram] = max(max_ref[gram], cnt)
        total = max(len(cand) - n + 1, 0)
        clipped = sum(min(cnt, max_ref[gram])
                      for gram, cnt in cand_ngrams.items())
        if n == 1:
            if total == 0 or clipped == 0:
                return 0.0
        else:
            total += 1
            clipped += 1
        log_p += math.log(clipped / total) / max_n
    ref_len = min((abs(len(r) - len(cand)), len(r))
                  for r in references)[1] if references else len(cand)
    bp = (1.0 if len(cand) > ref_len
          else math.exp(1.0 - ref_len / max(len(cand), 1)))
    return bp * math.exp(log_p)


def oracle_bleu4(candidate_groups: List[List[Sequence]],
                 references: List[List[Sequence]],
                 max_n: int = 4) -> float:
    """Best-of-G (oracle) BLEU: per sample, the candidate with the highest
    smoothed sentence BLEU against its references is selected, then corpus
    BLEU is computed over the selections.

    The standard way to score a DIVERSE decode set (e.g.
    :func:`eval.decode.diverse_beam_search`'s G captions per image): a
    high oracle with a low single-candidate BLEU means the set contains
    good captions a reranker could surface.
    """
    assert len(candidate_groups) == len(references)
    chosen = [max(group, key=lambda c: sentence_bleu(c, refs, max_n))
              for group, refs in zip(candidate_groups, references)]
    return corpus_bleu(chosen, references, max_n)


def corpus_bleu(candidates: List[Sequence],
                references: List[List[Sequence]],
                max_n: int = 4) -> float:
    """Corpus-level BLEU-``max_n`` with uniform weights.

    Args:
      candidates: list of token sequences (any hashable tokens).
      references: per-candidate list of reference token sequences.
    """
    assert len(candidates) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand = list(cand)
        cand_len += len(cand)
        # closest reference length (standard BLEU brevity penalty)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cand_ngrams = _ngrams(cand, n)
            max_ref: Counter = Counter()
            for ref in refs:
                for gram, cnt in _ngrams(list(ref), n).items():
                    max_ref[gram] = max(max_ref[gram], cnt)
            totals[n - 1] += max(len(cand) - n + 1, 0)
            clipped[n - 1] += sum(min(cnt, max_ref[gram])
                                  for gram, cnt in cand_ngrams.items())
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_precision = sum(math.log(c / t) for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
    return bp * math.exp(log_precision)
