"""Self-critical sequence training (``gan_image_captioning_tpu/train/scst.py``,
``--scst-epochs``): REINFORCE on a sentence reward with the model's own
greedy decode as the baseline (Rennie et al. 2017), between MLE
pretraining and adversarial training.

* **Rollout** (no gradient): one sampled caption per row
  (``eval/decode.sample_decode``, its Gumbel noise drawn from the
  ``torch.Generator`` the caller passes, or fed) and the greedy baseline
  (``eval/decode.greedy``: the serve kernel on CUDA tensors).
* **Reward** (host): CIDEr-D (idf fit once over the training references,
  ``eval/cider.CiderScorer``) or smoothed sentence BLEU-4 of the fetched
  ids; the advantage ``r(sampled) - r(greedy)`` enters the update as a
  constant.
* **Update**: ``loss = -mean(advantage · log π(sampled))``, log π the
  masked sum (up to and including the first ``<E>``) of the teacher-forced
  per-token log-probabilities of the sampled ids
  (``reinforce.sequence_log_probs``: the LSTM's differentiable rescore,
  whose backward runs the reverse BPTT kernel, or the transformer's causal
  pass through the flash kernels) — the function of the JAX package's
  ``eval/decode.sequence_logprob``, with its gradient.  The sampled ids,
  the rewards and the baseline carry no gradient.  The update is the
  clipped Adam of the adversarial generator's optimizer state
  (``gen_opt``) at ``--scst-lr`` (``--gen-lr`` when 0), and adds 1 to
  ``gen_steps``.

The instructor draws each rollout's noise from :func:`rollout_generator`
``(seed, scst_step)``, as the JAX instructor folds the global SCST step
into its base key: a resumed run draws the same noise.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.eval.metrics import strip_caption
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.train.reinforce import sequence_log_probs
from gan_image_captioning_tpu_torch.train.state import (
    clip_adam_update, require_ported_training)
from gan_image_captioning_tpu_torch.train.steps import _grads

ROLLOUT_SEED_OFFSET = 31        # the JAX instructor's PRNGKey(seed + 31)


def rollout_generator(seed: int, step: int, device) -> torch.Generator:
    """The rollout noise's generator for global SCST step ``step``: seeded
    from ``(seed, step)`` alone, never from a running stream."""
    bits = np.random.SeedSequence([seed + ROLLOUT_SEED_OFFSET, step])
    seed64 = int(bits.generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed64)


def sequence_logprob(config: Config, generator_model, features, ids):
    """Differentiable log π ``[B]`` of ``ids [B, T]``: the per-token
    teacher-forced log-probabilities summed up to and including each row's
    first ``<E>``."""
    return decode_lib.masked_logprob_sum(
        ids, sequence_log_probs(config, generator_model, features, ids))


def scst_loss(config: Config, state, batch, sampled_ids, advantage):
    """``-mean(advantage · log π(sampled_ids))`` with the conditioning in
    train mode (a conditional generator's BatchNorm statistics move once,
    as in the JAX update)."""
    cond, _ = api.generator_condition(config, state.gen, batch, train=True)
    lp = sequence_logprob(config, state.gen, cond["features"], sampled_ids)
    return -(advantage.detach() * lp).mean()


def make_scst_programs(config: Config):
    """``(rollout, update, greedy_only)``:

    ``rollout(gen, batch, rng, noise=None) -> (sampled_ids, greedy_ids)``
    (``noise``: fed Gumbel noise ``[T, B, V]`` in place of ``rng``'s);
    ``update(state, batch, sampled_ids, advantage) -> (state, loss)``,
    in place;
    ``greedy_only(gen, batch) -> greedy_ids`` (the val sweeps)."""
    require_ported_training(config)
    lr = config.scst_lr if config.scst_lr > 0 else config.gen_lr

    @torch.no_grad()
    def rollout(gen, batch, rng, noise=None):
        cond, _ = api.generator_condition(config, gen, batch, train=False)
        feats = cond["features"]
        sampled, _ = decode_lib.sample_decode(gen, feats, config, rng,
                                              noise=noise)
        return sampled, decode_lib.greedy(gen, feats, config)

    @torch.no_grad()
    def greedy_only(gen, batch):
        cond, _ = api.generator_condition(config, gen, batch, train=False)
        return decode_lib.greedy(gen, cond["features"], config)

    def update(state, batch, sampled_ids, advantage):
        loss = scst_loss(config, state, batch, sampled_ids, advantage)
        grads, = _grads(loss, state.gen)
        clip_adam_update(state.gen, grads, state.gen_opt, lr,
                         config.clip_norm)
        state.gen_steps += 1
        return state, loss.detach()

    return rollout, update, greedy_only


def build_row_references(dataset, multi_ref: bool) -> List[List[list]]:
    """Per dataset row, its reference set (stripped token lists): the
    row's own caption, or under ``multi_ref`` every caption of the row's
    image (rows grouped by ``dataset.image_key``)."""
    get = getattr(dataset, "caption_ids", None)
    if get is None:
        get = lambda i: dataset.sample(i)[0]  # noqa: E731
    caps = [strip_caption(get(i)) for i in range(len(dataset))]
    key_of = getattr(dataset, "image_key", None)
    if not multi_ref or key_of is None:
        return [[c] for c in caps]
    groups: dict = {}
    for i in range(len(dataset)):
        groups.setdefault(key_of(i), []).append(caps[i])
    return [groups[key_of(i)] for i in range(len(dataset))]


def build_reward_fn(config: Config, train_dataset, row_refs=None):
    """``--scst-reward`` as ``reward(cand_ids, refs) -> float`` over
    stripped token lists.  CIDEr's idf is fit over the training reference
    sets: one document per image under ``--scst-multi-ref``, else one per
    row."""
    if config.scst_reward == "bleu":
        from gan_image_captioning_tpu_torch.eval.bleu import sentence_bleu

        return lambda cand, refs: sentence_bleu(cand, refs)
    from gan_image_captioning_tpu_torch.eval.cider import CiderScorer

    if row_refs is None:
        row_refs = build_row_references(train_dataset,
                                        config.scst_multi_ref)
    if config.scst_multi_ref:
        seen, corpus = set(), []
        for refs in row_refs:
            key = tuple(tuple(r) for r in refs)
            if key not in seen:
                seen.add(key)
                corpus.append(refs)
    else:
        corpus = row_refs
    return CiderScorer(corpus).score


def _row_refs(i, ref_rows, row_refs, index):
    if row_refs is not None and index is not None:
        return row_refs[int(index[i])]
    return [strip_caption(ref_rows[i])]


def batch_advantage(reward_fn, sampled_ids: np.ndarray,
                    greedy_ids: np.ndarray, ref_rows: np.ndarray,
                    row_refs=None, index=None) -> np.ndarray:
    """Per row ``r(sampled) - r(greedy)`` (float32), against the row's
    image's reference set when ``row_refs`` and ``index`` are given, else
    the row's own caption from the batch."""
    adv = np.zeros((sampled_ids.shape[0],), np.float32)
    for i in range(sampled_ids.shape[0]):
        refs = _row_refs(i, ref_rows, row_refs, index)
        adv[i] = (reward_fn(strip_caption(sampled_ids[i]), refs)
                  - reward_fn(strip_caption(greedy_ids[i]), refs))
    return adv


def batch_reward(reward_fn, ids: np.ndarray, ref_rows: np.ndarray,
                 row_refs=None, index=None, weights=None):
    """``(sum, count)`` of the rewards of the real rows (pad rows, weight
    0, are left out)."""
    tot, cnt = 0.0, 0
    for i in range(ids.shape[0]):
        if weights is not None and weights[i] == 0:
            continue
        tot += reward_fn(strip_caption(ids[i]),
                         _row_refs(i, ref_rows, row_refs, index))
        cnt += 1
    return tot, cnt
