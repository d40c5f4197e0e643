"""METEOR (exact-match variant): unigram alignment F-mean with a
fragmentation penalty.

Rounds out the COCO leaderboard quartet (BLEU / METEOR / ROUGE-L / CIDEr)
for the reference's captioning task (``tasks.py:18-136``; the report itself
tabulates only NLL/BLEU, NLP_Report.pdf §4.3).  Full METEOR 1.5 adds
Porter-stem and WordNet-synonym match stages; neither resource exists in
this environment, so this is the documented EXACT-MATCH stage only — the
dominant stage in practice, and the same simplification nltk falls back to
without WordNet.  Standard parameters (Denkowski & Lavie 2014, en task):

    alpha = 0.9, beta = 3.0, gamma = 0.5
    Fmean = P * R / (alpha * P + (1 - alpha) * R)
    penalty = gamma * (chunks / matches) ** beta
    score = Fmean * (1 - penalty)

Per image the best-scoring reference is kept (METEOR's multi-ref rule);
the corpus score is the mean over images.  Alignment: leftmost one-to-one
unigram matching followed by chunk minimization over candidate order —
consecutive candidate matches mapping to consecutive reference positions
form one chunk.

The port's copy of ``gan_image_captioning_tpu/eval/meteor.py`` (the port
imports nothing of the JAX package): the same operations in the same
order, so the same numbers to the last bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

_ALPHA = 0.9
_BETA = 3.0
_GAMMA = 0.5


def _align(cand: Sequence, ref: Sequence) -> List[Tuple[int, int]]:
    """One-to-one exact unigram alignment, leftmost-first.

    For each candidate position (left to right) take the first unused
    reference position holding the same token — the greedy stage-1
    alignment METEOR seeds its beam with; exact for the common case of
    few repeated tokens.
    """
    used = [False] * len(ref)
    pairs = []
    for i, tok in enumerate(cand):
        for j, rtok in enumerate(ref):
            if not used[j] and tok == rtok:
                used[j] = True
                pairs.append((i, j))
                break
    return pairs


def _chunks(pairs: List[Tuple[int, int]]) -> int:
    """Number of maximal runs where both indices advance by exactly 1.
    ``pairs`` is already sorted by candidate index."""
    if not pairs:
        return 0
    n = 1
    for (pi, pj), (ci, cj) in zip(pairs, pairs[1:]):
        if ci != pi + 1 or cj != pj + 1:
            n += 1
    return n


def meteor_single(candidate: Sequence, references: List[Sequence],
                  alpha: float = _ALPHA, beta: float = _BETA,
                  gamma: float = _GAMMA) -> float:
    """Per-image METEOR: best score over the reference set."""
    cand = list(candidate)
    best = 0.0
    for ref in references:
        ref = list(ref)
        if not cand or not ref:
            continue
        pairs = _align(cand, ref)
        m = len(pairs)
        if m == 0:
            continue
        p = m / len(cand)
        r = m / len(ref)
        fmean = p * r / (alpha * p + (1.0 - alpha) * r)
        penalty = gamma * (_chunks(pairs) / m) ** beta
        best = max(best, fmean * (1.0 - penalty))
    return best


def meteor(candidates: List[Sequence],
           references: List[List[Sequence]],
           alpha: float = _ALPHA, beta: float = _BETA,
           gamma: float = _GAMMA) -> float:
    """Corpus METEOR (exact-match): mean over images of the per-image
    best-reference score."""
    assert len(candidates) == len(references)
    if not candidates:
        return 0.0
    total = sum(meteor_single(c, r, alpha, beta, gamma)
                for c, r in zip(candidates, references))
    return total / len(candidates)
