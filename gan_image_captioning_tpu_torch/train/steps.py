"""The MLE and adversarial training steps
(``gan_image_captioning_tpu/train/steps.py``).

* :func:`make_mle_step` — free-running pretrain sample (greedy ids from
  the decode kernel, then the differentiable teacher-forced rescore) or
  teacher forcing, cross-entropy over all positions, clipped Adam at
  ``pretrain_lr``.
* Conditional (``--conditional-gan 1``): each step runs the image encoder
  exactly once, in train mode (``api.generator_condition``), so every
  BatchNorm running statistic moves once per step, as the JAX steps merge
  one ``new_stats`` per step (``steps.py:230,292,411,665``); the decode
  and its rescore read the features and never re-run it.  ``images_u8``
  batches go through the ``image_norm`` kernel first.
* :func:`make_mle_eval_step` / :func:`make_adv_eval_step` — the losses in
  eval mode (running statistics read, not moved; no dropout, no label
  noise; no update), without gradients.
* The transformer generator's MLE step is the parallel causal pass with
  the keys past each caption's ``lengths`` masked (flash attention).
* ``--adv-objective reinforce`` (``train/reinforce.py``): the sampled ids,
  rollout rewards, the REINFORCE generator loss and the discriminator's
  loss on real against sampled ids; one backward of ``g_loss + d_loss``
  gives both gradient sets there too, since no cross term exists.
* :func:`make_adv_step` — one Gumbel-softmax sample, the reference's three
  discriminator passes (real, detached fake, generator), both losses and
  ONE backward of ``g_loss + d_loss`` that gives both gradient sets (the
  JAX ``adv_losses(grad_side="both")`` single-forward pullback): the fake
  pass reads ``soft.detach()``, the generator pass runs with detached
  discriminator parameters and ``g_loss`` reads a detached ``d_real``, so
  no cross term reaches either side.  The sample takes the decode route
  of ``decode_route(config)``; under ``kernel_embed`` it arrives already
  embedded by the CNN discriminator, as two tensors of one value, the
  fake pass's (gradient to the embedding weight only) and the generator
  pass's (gradient to the generator only): the same cut, made at the
  embedding.  The discriminator updates when
  ``gen_steps % disc_train_freq == 0``; the generator every step.

Batches are dicts of tensors on the models' device: ``captions [B, L]``
int, optionally ``lengths [B]`` and ``weights [B]`` (0 on pad rows).
Every random draw of a step can be fed through ``noise``: ``uniforms [T,
B, V]`` (the Gumbel uniforms), ``keep`` (the dropout keep masks, real /
fake / generator pass, of ``api.disc_keep_shape``: ``[B·R, F]`` for the
CNN) and ``flip [B]`` (the noisy-label swap), and for REINFORCE
``rollout_uniforms`` and a ``seed`` (``train/reinforce.py``); what is not
fed is drawn from ``state.generator``.  A step updates the state in
place and returns it with its metrics (0-d tensors).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import Config, decode_route
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import discriminator as disc_cnn
from gan_image_captioning_tpu_torch.models import generator as gen_lstm
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.ops.losses import (cross_entropy_loss,
                                                        gan_losses)
from gan_image_captioning_tpu_torch.train.reinforce import reinforce_losses
from gan_image_captioning_tpu_torch.train.state import (
    TrainState, clip_adam_update, global_norm, require_ported_training,
    trainable_parameters)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A :func:`~gan_image_captioning_tpu_torch.data.loader.make_batch`
    dict as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _grads(loss, *modules) -> List[Dict[str, torch.Tensor]]:
    """One backward of ``loss``; per module, the gradients of its trainable
    parameters by name (zeros where a parameter does not reach the
    loss)."""
    params = [trainable_parameters(m) for m in modules]
    flat = [p for ps in params for p in ps.values()]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    return [{k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(ps.items(), grads)} for ps in params]


def _draw_seed(state: TrainState) -> int:
    return int(torch.randint(2 ** 62, (), generator=state.generator))


def noisy_label_flip(flip, d_real, d_fake, num_rep: int):
    """Swap real and fake logits of the samples where ``flip [B]`` is set;
    a sample's ``num_rep`` logits (contiguous) flip together."""
    flip = flip.repeat_interleave(num_rep)
    return (torch.where(flip, d_fake, d_real),
            torch.where(flip, d_real, d_fake))


def _rep_weights(batch, num_rep: int):
    w = batch.get("weights")
    return None if w is None else w.repeat_interleave(num_rep)


def mle_loss(config: Config, state: TrainState, batch, train: bool = True):
    """The MLE objective: cross-entropy of the ``--mle-objective`` logits
    against the captions, over all positions (weighted by ``weights``)."""
    cond, _ = api.generator_condition(config, state.gen, batch, train=train)
    captions = batch["captions"]
    logits = api.generator_mle_outputs(state.gen, cond, captions, config,
                                       lengths=batch.get("lengths"))
    w = batch.get("weights")
    mask = None if w is None else w[:, None].expand(captions.shape)
    return cross_entropy_loss(logits, captions, mask)


def make_mle_step(config: Config):
    """Pretrain step: loss → grads → clip → Adam(``pretrain_lr``)."""
    require_ported_training(config)

    def step(state: TrainState, batch):
        loss = mle_loss(config, state, batch)
        grads, = _grads(loss, state.gen)
        gnorm = clip_adam_update(state.gen, grads, state.pretrain_opt,
                                 config.pretrain_lr, config.clip_norm)
        return state, {"gen_pretrain_loss": loss.detach(),
                       "gen_grad_norm": gnorm}

    return step


def make_mle_eval_step(config: Config):
    """Eval-mode MLE loss (reference ``genpretrain_loop('val')``): no
    gradient, no update, running statistics read."""
    require_ported_training(config)

    @torch.no_grad()
    def step(state: TrainState, batch):
        return state, {"gen_pretrain_loss": mle_loss(config, state, batch,
                                                     train=False)}

    return step


def adv_losses(config: Config, state: TrainState, batch, temperature,
               noise: Optional[Dict[str, Any]] = None, train: bool = True):
    """One adversarial forward → ``(g_loss, d_loss, aux)`` with the
    cross terms cut as the module docstring says (``train=False``: eval
    mode, no dropout, no label noise)."""
    noise = noise or {}
    if config.adv_objective == "reinforce":
        seed = noise.get("seed")
        return reinforce_losses(
            config, state, batch, _draw_seed(state) if seed is None else seed,
            noise, train)
    if config.adv_objective != "gumbel":
        raise ValueError(f"adv_objective {config.adv_objective!r}: expected "
                         "'gumbel' or 'reinforce'")
    cond, _ = api.generator_condition(config, state.gen, batch, train=train)
    captions = batch["captions"]
    device = captions.device
    draw = torch.Generator(device=device).manual_seed(_draw_seed(state))
    disc_p = params_of(state.disc)
    disc_ng = params_of(state.disc, detach=True)
    keeps = noise.get("keep", (None, None, None))
    sample_kw = dict(temperature=temperature, seed=_draw_seed(state),
                     uniforms=noise.get("uniforms"))
    if decode_route(config) == "kernel_embed":
        # the sample arrives embedded: emb_fake carries gradient to the
        # embedding weight only, emb_gen to the generator only
        emb_gen, emb_fake, gen_ids = gen_lstm.sample_embed(
            state.gen.decoder, cond["features"], captions.shape[1],
            disc_embed=disc_p["embeddings.weight"], **sample_kw)
        d_real = api.discriminator_apply(disc_p, captions, config, train,
                                         keeps[0], draw)
        d_fake = disc_cnn.apply_embedded(disc_p, emb_fake, config, train,
                                         keeps[1], draw)
        g_out = disc_cnn.apply_embedded(disc_ng, emb_gen, config, train,
                                        keeps[2], draw)
    else:
        soft, gen_ids = api.generator_sample(
            state.gen, cond, captions.shape[1], False, config, **sample_kw)
        d_real = api.discriminator_apply(disc_p, captions, config, train,
                                         keeps[0], draw)
        d_fake = api.discriminator_apply(disc_p, soft.detach(), config,
                                         train, keeps[1], draw)
        g_out = api.discriminator_apply(disc_ng, soft, config, train,
                                        keeps[2], draw)

    num_rep = api.disc_logits_per_sample(config)
    if config.noisy_labels > 0.0 and train:
        flip = noise.get("flip")
        if flip is None:
            flip = torch.rand(captions.shape[0], generator=draw,
                              device=device) < config.noisy_labels
        d_real_in, d_fake_in = noisy_label_flip(flip, d_real, d_fake,
                                                num_rep)
    else:
        d_real_in, d_fake_in = d_real, d_fake
    w = _rep_weights(batch, num_rep)
    real_label = 1.0 - config.label_smoothing
    _, d_loss = gan_losses(d_real_in, d_fake_in, g_out, config.adv_loss_type,
                           real_label=real_label, weights=w)
    g_loss, _ = gan_losses(d_real.detach(), g_out, g_out,
                           config.adv_loss_type, real_label=real_label,
                           weights=w)
    aux = {"gen_ids": gen_ids, "d_real_mean": d_real.detach().mean(),
           "d_fake_mean": d_fake.detach().mean()}
    return g_loss, d_loss, aux


def adv_grads(config: Config, state: TrainState, batch, temperature,
              noise: Optional[Dict[str, Any]] = None):
    """``(g_loss, d_loss, gen_grads, disc_grads, aux)`` from one forward
    and one backward of ``g_loss + d_loss``; the state is not changed
    (beyond drawing from ``state.generator``)."""
    g_loss, d_loss, aux = adv_losses(config, state, batch, temperature,
                                     noise)
    g_grads, d_grads = _grads(g_loss + d_loss, state.gen, state.disc)
    return g_loss.detach(), d_loss.detach(), g_grads, d_grads, aux


def make_adv_step(config: Config):
    """The adversarial update: both gradients from one forward and one
    backward, the discriminator's clipped Adam every ``disc_train_freq``
    generator steps, the generator's every step."""
    require_ported_training(config)
    disc_every = max(1, int(config.disc_train_freq))

    def step(state: TrainState, batch, temperature,
             noise: Optional[Dict[str, Any]] = None):
        g_loss, d_loss, g_grads, d_grads, aux = adv_grads(
            config, state, batch, temperature, noise)
        # pre-clip norms, also on steps that do not update the discriminator
        g_norm, d_norm = global_norm(g_grads), global_norm(d_grads)
        if state.gen_steps % disc_every == 0:
            clip_adam_update(state.disc, d_grads, state.disc_opt,
                             config.disc_lr, config.clip_norm, d_norm)
            state.disc_steps += 1
        clip_adam_update(state.gen, g_grads, state.gen_opt, config.gen_lr,
                         config.clip_norm, g_norm)
        state.gen_steps += 1
        state.temperature = float(temperature)
        return state, {"gen_adv_loss": g_loss, "disc_adv_loss": d_loss,
                       "d_real_mean": aux["d_real_mean"],
                       "d_fake_mean": aux["d_fake_mean"],
                       "gen_grad_norm": g_norm, "disc_grad_norm": d_norm}

    return step


def make_adv_eval_step(config: Config):
    """Eval-mode adversarial losses (reference ``adv_loop('val')``): no
    gradient, no update; the Gumbel sample still draws its noise."""
    require_ported_training(config)

    @torch.no_grad()
    def step(state: TrainState, batch, temperature,
             noise: Optional[Dict[str, Any]] = None):
        g_loss, d_loss, aux = adv_losses(config, state, batch, temperature,
                                         noise, train=False)
        return state, {"gen_adv_loss": g_loss, "disc_adv_loss": d_loss,
                       "d_real_mean": aux["d_real_mean"],
                       "d_fake_mean": aux["d_fake_mean"]}

    return step
