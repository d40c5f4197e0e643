"""The port's caption-quality metrics (``eval/{bleu,cider,rouge,meteor,
diversity,metrics}.py``) against the JAX package's on seeded random
corpora: single and multiple references, empty candidates and
references, repeated tokens.  The port keeps copies of the pure-Python
modules, so every number must be equal to the last bit (``==`` on the
floats)."""

import numpy as np
import pytest

from gan_image_captioning_tpu.eval import bleu as jbleu
from gan_image_captioning_tpu.eval import cider as jcider
from gan_image_captioning_tpu.eval import diversity as jdiv
from gan_image_captioning_tpu.eval import meteor as jmeteor
from gan_image_captioning_tpu.eval import metrics as jmetrics
from gan_image_captioning_tpu.eval import rouge as jrouge
from gan_image_captioning_tpu_torch.eval import bleu as tbleu
from gan_image_captioning_tpu_torch.eval import cider as tcider
from gan_image_captioning_tpu_torch.eval import diversity as tdiv
from gan_image_captioning_tpu_torch.eval import meteor as tmeteor
from gan_image_captioning_tpu_torch.eval import metrics as tmetrics
from gan_image_captioning_tpu_torch.eval import rouge as trouge


def _sentence(rng, vocab=12, max_len=9, min_len=0):
    return [int(t) for t in rng.integers(3, 3 + vocab,
                                         rng.integers(min_len, max_len + 1))]


def corpus(seed, n=24, refs=1, vocab=12):
    """``(candidates, references)``: a few candidates copied from or
    overlapping their references, the rest random; some empty."""
    rng = np.random.default_rng(seed)
    cands, all_refs = [], []
    for i in range(n):
        rs = [_sentence(rng, vocab, min_len=1) for _ in range(refs)]
        kind = i % 4
        if kind == 0:
            cand = list(rs[0])
        elif kind == 1:
            cand = rs[0][: max(1, len(rs[0]) // 2)] + _sentence(rng, vocab, 4)
        elif kind == 2:
            cand = _sentence(rng, vocab)
        else:
            cand = [] if i % 8 == 3 else _sentence(rng, vocab, 3)
        cands.append(cand)
        all_refs.append(rs)
    return cands, all_refs


CASES = [(seed, refs) for seed in (0, 1, 2) for refs in (1, 5)]


@pytest.mark.parametrize("seed,refs", CASES)
def test_corpus_metrics_equal_jax(seed, refs):
    cands, rs = corpus(seed, refs=refs)
    for name, jf, tf in (("corpus_bleu", jbleu.corpus_bleu,
                          tbleu.corpus_bleu),
                         ("cider_d", jcider.cider_d, tcider.cider_d),
                         ("rouge_l", jrouge.rouge_l, trouge.rouge_l),
                         ("meteor", jmeteor.meteor, tmeteor.meteor)):
        want, got = jf(cands, rs), tf(cands, rs)
        assert got == want, (name, got, want)
    assert tbleu.corpus_bleu(cands, rs, max_n=2) == jbleu.corpus_bleu(
        cands, rs, max_n=2)


@pytest.mark.parametrize("seed,refs", CASES)
def test_sentence_metrics_equal_jax(seed, refs):
    cands, rs = corpus(seed, refs=refs)
    scorer_j = jcider.CiderScorer(rs)
    scorer_t = tcider.CiderScorer(rs)
    for c, r in zip(cands, rs):
        assert tbleu.sentence_bleu(c, r) == jbleu.sentence_bleu(c, r)
        assert trouge.rouge_l_single(c, r) == jrouge.rouge_l_single(c, r)
        assert tmeteor.meteor_single(c, r) == jmeteor.meteor_single(c, r)
        assert scorer_t.score(c, r) == scorer_j.score(c, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_bleu_equals_jax(seed):
    rng = np.random.default_rng(seed + 10)
    cands, rs = corpus(seed, refs=3)
    groups = [[c] + [_sentence(rng) for _ in range(2)] for c in cands]
    assert tbleu.oracle_bleu4(groups, rs) == jbleu.oracle_bleu4(groups, rs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diversity_equals_jax(seed):
    cands, _ = corpus(seed, n=40, vocab=6)
    cands += [list(cands[0])] * 5              # a collapsed share
    for n in (1, 2, 3):
        assert tdiv.distinct_n(cands, n) == jdiv.distinct_n(cands, n)
    assert tdiv.self_bleu(cands) == jdiv.self_bleu(cands)
    assert tdiv.self_bleu(cands, sample_size=7) == jdiv.self_bleu(
        cands, sample_size=7)


def test_degenerate_corpora_equal_jax():
    for cands, rs in (([], []), ([[]], [[[]]]), ([[4, 5]], [[[]]]),
                      ([[]], [[[4, 5, 6]]]), ([[4, 4, 4, 4]], [[[4, 4]]])):
        for jf, tf in ((jcider.cider_d, tcider.cider_d),
                       (jrouge.rouge_l, trouge.rouge_l),
                       (jmeteor.meteor, tmeteor.meteor)):
            assert tf(cands, rs) == jf(cands, rs)
        if cands and rs[0][0]:
            assert tbleu.corpus_bleu(cands, rs) == jbleu.corpus_bleu(cands,
                                                                     rs)
    assert tdiv.self_bleu([[3]]) == jdiv.self_bleu([[3]]) == 0.0
    assert tdiv.distinct_n([[3]], 2) == jdiv.distinct_n([[3]], 2) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_bleu4_from_batches_equals_jax(seed):
    """Decoded id batches with <S>, <E>, <PAD> and zero-weight rows."""
    rng = np.random.default_rng(seed)
    gen = [rng.integers(0, 12, (6, 9)).astype(np.int32) for _ in range(3)]
    real = [rng.integers(3, 12, (6, 9)).astype(np.int32) for _ in range(3)]
    for r in real:
        r[:, 0], r[:, 6] = 1, 2                       # <S> ... <E>
    for g, r in zip(gen, real):                        # overlap with refs
        g[::2] = r[::2]
    weights = [np.ones(6, np.float32), np.ones(6, np.float32),
               np.array([1, 1, 1, 0, 0, 0], np.float32)]
    want = jmetrics.bleu4_from_batches(gen, real, weights)
    assert want > 0.0
    assert tmetrics.bleu4_from_batches(gen, real, weights) == want
    assert tmetrics.bleu4_from_batches(gen, real, [None] * 3) == \
        jmetrics.bleu4_from_batches(gen, real, [None] * 3)
    assert tmetrics.bleu4_from_batches([], [], []) == 0.0
