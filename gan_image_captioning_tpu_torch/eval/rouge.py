"""ROUGE-L: longest-common-subsequence caption metric.

The reference's report tabulates only NLL_gen and BLEU-4 (NLP_Report.pdf
§4.3), but its task is COCO captioning (``tasks.py:18-136``) and the COCO
leaderboard reports ROUGE-L alongside BLEU/METEOR/CIDEr.  This is the
coco-caption variant (Lin, 2004; beta = 1.2): per image, the LCS-based
F-measure is taken against each reference and the MAX is kept; the corpus
score is the mean over images.

    P = LCS(c, r) / |c|,  R = LCS(c, r) / |r|
    F = (1 + beta^2) * P * R / (R + beta^2 * P)

Pure host-side Python over small token lists (runs once per eval sweep);
hand-checkable tests in the JAX package's tests/test_quality_metrics.py.

The port's copy of ``gan_image_captioning_tpu/eval/rouge.py`` (the port
imports nothing of the JAX package): the same operations in the same
order, so the same numbers to the last bit.
"""

from __future__ import annotations

from typing import List, Sequence

_BETA = 1.2


def _lcs_len(a: Sequence, b: Sequence) -> int:
    """Classic O(|a|·|b|) LCS length with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_single(candidate: Sequence, references: List[Sequence],
                   beta: float = _BETA) -> float:
    """Per-image ROUGE-L: max F_lcs over the reference set."""
    cand = list(candidate)
    best = 0.0
    for ref in references:
        ref = list(ref)
        if not cand or not ref:
            continue
        lcs = _lcs_len(cand, ref)
        if lcs == 0:
            continue
        p = lcs / len(cand)
        r = lcs / len(ref)
        f = (1.0 + beta * beta) * p * r / (r + beta * beta * p)
        best = max(best, f)
    return best


def rouge_l(candidates: List[Sequence],
            references: List[List[Sequence]],
            beta: float = _BETA) -> float:
    """Corpus ROUGE-L: mean over images of the per-image max-F score."""
    assert len(candidates) == len(references)
    if not candidates:
        return 0.0
    total = sum(rouge_l_single(c, r, beta)
                for c, r in zip(candidates, references))
    return total / len(candidates)
