"""Policy-gradient adversarial training with rollout rewards
(``gan_image_captioning_tpu/train/reinforce.py``, ``--adv-objective
reinforce``).

* The sample is the Gumbel-max draw the decode already makes (the soft
  outputs are not used): ``argmax(logits + g)`` per step.
* :func:`rollout_rewards`: for the prefix lengths ``p = stride, 2·stride, …
  < T`` the sampled prefix is completed ``rollout_num`` times by the policy
  (all completions of one prefix as one decode of ``B · K`` rows) and
  scored by the discriminator; position t's reward is the mean
  real-probability of the first evaluated prefix length ≥ t + 1
  (:func:`position_reward_index`), the full sequence's own score past the
  last one.
* :func:`reinforce_losses`: ``g_loss = -mean_t[(r_t - b) · log π(y_t |
  y_<t)]`` with the log-probs from a teacher-forced pass over the sampled
  ids (:func:`sequence_log_probs`), ``b`` the greedy decode's score
  (``greedy``) or the batch mean reward; the discriminator's loss is the
  configured GAN loss of real ids against the sampled ids.

Every stop-gradient of the JAX package is kept: the sampled ids, the
rewards and the baseline carry no gradient (they are computed under
``no_grad``), and the discriminator reads int ids on both sides.  So
``g_loss`` reaches only the generator and ``d_loss`` only the
discriminator, and one backward of their sum gives the JAX step's two
per-loss gradients.  Noise can be fed (``noise`` of :func:`reinforce_losses`):
the sample's ``uniforms [T, B, V]``, the rollouts' ``rollout_uniforms``
(one ``[T, B·K, V]`` per prefix length), the two dropout ``keep`` masks and
a ``seed`` for whatever is drawn instead.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from gan_image_captioning_tpu_torch.config import Config, decode_route
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import generator as gen_lstm
from gan_image_captioning_tpu_torch.models import lstm
from gan_image_captioning_tpu_torch.models import transformer as gen_tf
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise
from gan_image_captioning_tpu_torch.ops.losses import gan_losses


# ----------------------------------------------------------------- sampling

def _draw_u(uniforms, t, shape, generator, device):
    if uniforms is not None:
        return uniforms[t]
    return torch.rand(shape, generator=generator, device=device)


@torch.no_grad()
def _prefix_decode_lstm(decoder, features, forced, prefix_len: int,
                        seq_len: int, uniforms=None, generator=None):
    """Free-running LSTM decode whose first ``prefix_len`` tokens are
    ``forced [B, T]`` → sampled ids ``[B, T]`` (no gradient)."""
    layers = decoder.lstm.layers()
    fused = lstm.fuse_layer_params(layers)
    batch = features.shape[0]
    state = lstm.zero_state(len(layers), batch, layers[0]["w_hh"].shape[1],
                            features.dtype, features.device)
    x, ids = features, []
    for t in range(seq_len):
        h, state = lstm.lstm_step(fused, x, state)
        logits = h @ decoder.linear.weight.T + decoder.linear.bias
        u = _draw_u(uniforms, t, logits.shape, generator, logits.device)
        sampled = torch.argmax(logits + gumbel_noise(u.shape, u=u), dim=-1)
        ids_t = forced[:, t].long() if t < prefix_len else sampled
        ids.append(ids_t)
        x = decoder.embed.weight[ids_t]
    return torch.stack(ids, dim=1)


@torch.no_grad()
def _prefix_decode_transformer(decoder, features, forced, prefix_len: int,
                               seq_len: int, config: Config, uniforms=None,
                               generator=None):
    """The transformer twin of :func:`_prefix_decode_lstm` over the KV
    cache."""
    p = params_of(decoder)
    k_cache, v_cache = gen_tf._init_kv_cache(config, features.shape[0],
                                             features.dtype, features.device)
    x, ids = features, []
    for t in range(seq_len):
        logits, k_cache, v_cache = gen_tf.decode_step(p, config, x, k_cache,
                                                      v_cache, t)
        u = _draw_u(uniforms, t, logits.shape, generator, logits.device)
        sampled = torch.argmax(logits + gumbel_noise(u.shape, u=u), dim=-1)
        ids_t = forced[:, t].long() if t < prefix_len else sampled
        ids.append(ids_t)
        x = p["embed"][ids_t]
    return torch.stack(ids, dim=1)


def _prefix_decode(config: Config, generator_model, features, forced,
                   prefix_len, seq_len, uniforms=None, generator=None):
    if config.gen_arch == "lstm":
        return _prefix_decode_lstm(generator_model.decoder, features, forced,
                                   prefix_len, seq_len, uniforms, generator)
    return _prefix_decode_transformer(generator_model.decoder, features,
                                      forced, prefix_len, seq_len, config,
                                      uniforms, generator)


# ------------------------------------------------------------------ rewards

@torch.no_grad()
def _disc_prob(config: Config, disc_params, ids):
    """Per-sample probability of real: the sigmoid of the eval-mode logits,
    averaged over each sample's logits."""
    logits = api.discriminator_apply(disc_params, ids, config, train=False)
    per = api.disc_logits_per_sample(config)
    return torch.sigmoid(logits.float()).reshape(-1, per).mean(dim=-1)


def position_reward_index(t_len: int, stride: int, num_positions: int):
    """Row of the reward table covering position t: the first evaluated
    prefix length ≥ t + 1; the full-sequence row (``num_positions``) past
    the last stride point."""
    return torch.clamp(torch.arange(t_len) // stride, max=num_positions)


@torch.no_grad()
def rollout_rewards(config: Config, generator_model, disc_params, features,
                    ids, rollout_uniforms=None, generator=None):
    """Monte-Carlo rollout rewards ``[B, T]`` (no gradient).
    ``rollout_uniforms``: one ``[T, B·K, V]`` per evaluated prefix length,
    or None to draw from ``generator``."""
    b, t_len = ids.shape
    k = max(1, int(config.rollout_num))
    stride = max(1, int(config.rollout_stride))
    positions = list(range(stride, t_len, stride))
    d_full = _disc_prob(config, disc_params, ids)                # [B]
    if config.rollout_num <= 0 or not positions:
        return d_full[:, None].expand(b, t_len).clone()
    feats_k = features.repeat_interleave(k, dim=0)
    forced = ids.repeat_interleave(k, dim=0)                     # [B·K, T]
    per_pos = []
    for i, p in enumerate(positions):
        u = None if rollout_uniforms is None else rollout_uniforms[i]
        roll = _prefix_decode(config, generator_model, feats_k, forced, p,
                              t_len, u, generator)
        per_pos.append(_disc_prob(config, disc_params, roll)
                       .reshape(b, k).mean(dim=-1))
    table = torch.stack(per_pos + [d_full])                      # [P+1, B]
    idx = position_reward_index(t_len, stride, len(positions))
    return table[idx.to(table.device)].T


# ---------------------------------------------------------------- log-probs

def sequence_log_probs(config: Config, generator_model, features, ids):
    """Differentiable ``log π_t(y_t | y_<t)`` ``[B, T]``, teacher-forced
    over the sampled ids: the LSTM's :func:`generator.rescore` (its
    backward through the reverse BPTT kernel; the fed-back embedding rows
    take gradient, the ids none), the transformer's one causal pass
    (flash attention without lengths).  SCST's log π is its masked sum
    (``train/scst.py``)."""
    t_len = ids.shape[1]
    dec = generator_model.decoder
    if config.gen_arch == "lstm":
        logits = gen_lstm.rescore(dec, features, ids,
                                  plain=decode_route(config) == "plain")
    else:
        logits = gen_tf.teacher_forced(dec, features, ids, config)[:, :t_len]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(2, ids.long()[..., None])[..., 0]


# ------------------------------------------------------------------- losses

def reinforce_losses(config: Config, state, batch, seed: int,
                     noise: Optional[Dict[str, Any]] = None,
                     train: bool = True):
    """The twin of ``steps.adv_losses`` for ``--adv-objective reinforce``
    → ``(g_loss, d_loss, aux)``.  The temperature is not used: the sample
    is an exact categorical draw.  ``seed`` keys whatever noise is not
    fed."""
    noise = noise or {}
    captions = batch["captions"]
    seq_len = captions.shape[1]
    device = captions.device
    draw = torch.Generator(device=device).manual_seed(seed)
    cond, _ = api.generator_condition(config, state.gen, batch, train=train)
    with torch.no_grad():
        _, gen_ids = api.generator_sample(
            state.gen, cond, seq_len, False, config, 1.0, seed=seed,
            uniforms=noise.get("uniforms"))
    gen_ids = gen_ids.detach()

    disc_p = params_of(state.disc)
    keeps = noise.get("keep", (None, None))
    d_real = api.discriminator_apply(disc_p, captions, config, train,
                                     keeps[0], draw).float()
    d_fake = api.discriminator_apply(disc_p, gen_ids, config, train,
                                     keeps[1], draw).float()
    w = batch.get("weights")
    per = api.disc_logits_per_sample(config)
    w_rep = None if w is None else w.repeat_interleave(per)
    real_label = 1.0 - config.label_smoothing
    _, d_loss = gan_losses(d_real, d_fake, d_fake, config.adv_loss_type,
                           real_label=real_label, weights=w_rep)

    disc_ng = params_of(state.disc, detach=True)
    feats_ng = cond["features"].detach()
    rewards = rollout_rewards(config, state.gen, disc_ng, feats_ng, gen_ids,
                              noise.get("rollout_uniforms"), draw)
    with torch.no_grad():
        if config.rl_baseline == "greedy":
            _, greedy = api.generator_sample(state.gen, {**cond, "features":
                                                         feats_ng},
                                             seq_len, True, config)
            baseline = _disc_prob(config, disc_ng, greedy)[:, None]
        else:
            baseline = rewards.mean(dim=0, keepdim=True)
        advantage = rewards - baseline

    logp = sequence_log_probs(config, state.gen, cond["features"], gen_ids)
    per_sample = -(advantage * logp).mean(dim=-1)
    if w is not None:
        g_loss = (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)
    else:
        g_loss = per_sample.mean()
    aux = {"gen_ids": gen_ids, "d_real_mean": d_real.detach().mean(),
           "d_fake_mean": d_fake.detach().mean(),
           "mean_reward": rewards.mean()}
    return g_loss, d_loss, aux
