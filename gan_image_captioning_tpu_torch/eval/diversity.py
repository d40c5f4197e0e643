"""Diversity metrics for adversarial text generation.

The reference evaluates quality only (NLL_gen / BLEU-4, NLP_Report.pdf
§4.3) — but the GAN-text literature it builds on (RelGAN, whose
discriminator/ Gumbel design the reference adopts, ``discriminator.py:9-86``,
``generator.py:84-96``) reports diversity alongside quality, because
adversarial fine-tuning trades one for the other (mode collapse raises
BLEU while killing variety).  This module adds the two standard probes:

* **Self-BLEU** (Texygen): mean BLEU of each generated caption against
  the OTHER generated captions as references.  1.0 = every caption
  identical (collapse); lower = more diverse.
* **Distinct-n** (Li et al. 2016): unique n-grams / total n-grams over
  the generated corpus.  Higher = more diverse.

Both are host-side corpus statistics over decoded id sequences — no
device work.

The port's copy of ``gan_image_captioning_tpu/eval/diversity.py`` (the port
imports nothing of the JAX package): the same operations in the same
order, so the same numbers to the last bit.
"""

from __future__ import annotations

from typing import List, Sequence

from gan_image_captioning_tpu_torch.eval.bleu import corpus_bleu


def self_bleu(captions: List[Sequence], max_n: int = 4,
              sample_size: int = 200) -> float:
    """Mean leave-one-out corpus BLEU of ``captions`` against each other.

    ``sample_size`` caps the O(N²) n-gram work: the first ``sample_size``
    captions are scored (each against ALL other captions as references),
    which is the Texygen convention for large corpora.  Returns 0.0 for
    fewer than 2 captions.
    """
    captions = [list(c) for c in captions if len(c) > 0]
    if len(captions) < 2:
        return 0.0
    scored = captions[:sample_size]
    cands, refs = [], []
    for i, cand in enumerate(scored):
        others = captions[:i] + captions[i + 1:]
        cands.append(cand)
        refs.append(others)
    return corpus_bleu(cands, refs, max_n=max_n)


def distinct_n(captions: List[Sequence], n: int = 2) -> float:
    """Unique n-grams / total n-grams across the corpus (0 when no caption
    reaches length ``n``)."""
    seen = set()
    total = 0
    for cap in captions:
        cap = list(cap)
        for i in range(len(cap) - n + 1):
            seen.add(tuple(cap[i: i + n]))
            total += 1
    return len(seen) / total if total else 0.0
