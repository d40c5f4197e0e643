"""CIDEr-D: the standard MS-COCO captioning metric.

The reference's report tabulates only NLL_gen and BLEU-4 (NLP_Report.pdf
§4.3) — but its task IS COCO captioning (``tasks.py:18-136``), and the
COCO leaderboard metric is CIDEr (Vedantam et al., CVPR 2015).  This is
the CIDEr-D variant used by the official coco-caption toolkit: tf-idf
weighted n-gram cosine similarity (n = 1..4), candidate counts clipped to
reference counts, a Gaussian length penalty (sigma = 6), and the
conventional 10x scale.

Implemented from the published formula (no toolkit code available in this
environment); hand-checkable tests in the JAX package's tests/test_quality_metrics.py pin
the invariants (identical captions score 10 x mean-ref-similarity,
disjoint vocab scores 0, idf kills corpus-constant n-grams).

The port's copy of ``gan_image_captioning_tpu/eval/cider.py`` (the port
imports nothing of the JAX package): the same operations in the same
order, so the same numbers to the last bit.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

_SIGMA = 6.0
_MAX_N = 4


def _ngram_counts(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def _tfidf_vec(counts: Counter, doc_freq: Dict[Tuple, int],
               num_refs_log: float) -> Tuple[Dict[Tuple, float], float]:
    """tf-idf vector + its L2 norm.  tf is the RAW count (coco-caption's
    choice), idf = log(N / df) with df computed over reference SETS."""
    vec = {}
    norm_sq = 0.0
    for gram, cnt in counts.items():
        idf = num_refs_log - math.log(max(doc_freq.get(gram, 0), 1))
        val = cnt * idf
        vec[gram] = val
        norm_sq += val * val
    return vec, math.sqrt(norm_sq)


def cider_d(candidates: List[Sequence],
            references: List[List[Sequence]]) -> float:
    """Corpus CIDEr-D: mean over images of the per-image score.

    Args:
      candidates: one generated token sequence per image.
      references: per-image list of reference token sequences.  Document
        frequency is computed over these reference sets (one "document"
        per image), as in coco-caption.
    """
    assert len(candidates) == len(references)
    num_images = len(candidates)
    if num_images == 0:
        return 0.0
    doc_freq, log_n = _fit_doc_freq(references)

    total = 0.0
    for cand, refs in zip(candidates, references):
        total += _image_score(list(cand), refs, doc_freq, log_n)
    return total / num_images


def _fit_doc_freq(references: List[List[Sequence]]):
    """Document frequency per n (in how many images' reference sets does
    the n-gram appear?) + the idf log base; coco-caption guards log(1)=0."""
    doc_freq = [defaultdict(int) for _ in range(_MAX_N)]
    for refs in references:
        for n in range(1, _MAX_N + 1):
            grams = set()
            for ref in refs:
                grams.update(_ngram_counts(list(ref), n).keys())
            for gram in grams:
                doc_freq[n - 1][gram] += 1
    return doc_freq, math.log(max(len(references), 2))


def _image_score(cand: list, refs: List[Sequence],
                 doc_freq: List[Dict], log_n: float) -> float:
    """One image's CIDEr-D against its reference set under a given idf."""
    img_score = 0.0
    for n in range(1, _MAX_N + 1):
        cand_counts = _ngram_counts(cand, n)
        per_ref = 0.0
        for ref in refs:
            ref = list(ref)
            ref_counts = _ngram_counts(ref, n)
            # CIDEr-D clips candidate counts to the reference's
            clipped = Counter({g: min(c, ref_counts.get(g, 0))
                               for g, c in cand_counts.items()})
            c_vec, c_norm = _tfidf_vec(clipped, doc_freq[n - 1], log_n)
            r_vec, r_norm = _tfidf_vec(ref_counts, doc_freq[n - 1], log_n)
            if c_norm == 0.0 or r_norm == 0.0:
                continue
            dot = sum(val * r_vec.get(gram, 0.0)
                      for gram, val in c_vec.items())
            delta = len(cand) - len(ref)
            penalty = math.exp(-(delta * delta) / (2.0 * _SIGMA ** 2))
            per_ref += penalty * dot / (c_norm * r_norm)
        img_score += per_ref / max(len(refs), 1)
    return 10.0 * img_score / _MAX_N


class CiderScorer:
    """Per-sentence CIDEr-D against a FIXED reference corpus idf.

    SCST (train/scst.py) needs per-sample rewards scored thousands of
    times against the same training corpus — recomputing document
    frequencies per batch would both cost O(corpus) each call and make the
    reward non-stationary.  ``fit`` precomputes idf over the training
    reference sets once (one "document" per image, as coco-caption does);
    ``score`` then prices a single candidate.
    """

    def __init__(self, corpus_references: List[List[Sequence]]):
        self.num_images = len(corpus_references)
        self.doc_freq, self.log_n = _fit_doc_freq(corpus_references)

    def score(self, candidate: Sequence, references: List[Sequence]) -> float:
        return _image_score(list(candidate), references, self.doc_freq,
                            self.log_n)
