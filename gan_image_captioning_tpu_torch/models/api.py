"""Architecture dispatch (``gan_image_captioning_tpu/models/api.py``).

Ported: the LSTM and transformer generators, unconditional or
conditional on the ResNet-18 or ViT-B/16 encoder (the conditional
transformer cross-attends over the encoder's grid; the LSTM can take the
frozen backbone's cached features, ``--cache-features``), and the CNN,
transformer, autoregressive-transformer and bidirectional-LSTM
discriminators; :func:`require_ported` turns any other configuration
away.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gan_image_captioning_tpu_torch.config import (Config, compute_dtype,
                                                   decode_route,
                                                   require_ported_arch)
from gan_image_captioning_tpu_torch.kernels.image_norm import (
    normalize_images, normalize_images_plain)
from gan_image_captioning_tpu_torch.models import discriminator as disc_cnn
from gan_image_captioning_tpu_torch.models import (
    discriminator_bilstm as disc_bilstm)
from gan_image_captioning_tpu_torch.models import (
    discriminator_transformer as disc_tf)
from gan_image_captioning_tpu_torch.models import encoder as encoder_lib
from gan_image_captioning_tpu_torch.models import generator as gen_lstm
from gan_image_captioning_tpu_torch.models import transformer as gen_tf


def require_ported(config: Config) -> None:
    """Raise for a configuration whose models are not ported yet
    (``config.require_ported_arch``)."""
    require_ported_arch(config)


def init_generator(generator: torch.Generator, config: Config, device="cpu",
                   sweep: bool = True):
    """A seeded generator of ``config.gen_arch``."""
    require_ported(config)
    if config.gen_arch == "lstm":
        return gen_lstm.init_generator_params(generator, config, device,
                                              sweep)
    return gen_tf.init_transformer_generator_params(generator, config,
                                                    device, sweep)


def _images(config: Config, batch: Dict[str, Any]):
    """The batch's images: ``images``, or ``images_u8`` normalized on the
    device (the ``image_norm`` kernel, or its plain version under
    ``image_norm_impl="plain"``) into the compute dtype, float32 or, under
    ``--dtype bfloat16``, bfloat16 (the JAX ``api.generator_condition``)."""
    if "images_u8" in batch:
        if config.image_norm_impl not in ("kernel", "plain"):
            raise ValueError(f"image_norm_impl {config.image_norm_impl!r}: "
                             "expected 'kernel' or 'plain'")
        norm = (normalize_images_plain if config.image_norm_impl == "plain"
                else normalize_images)
        return norm(batch["images_u8"], compute_dtype(config))
    return batch["images"]


def generator_condition(config: Config, generator: gen_lstm.Generator,
                        batch: Dict[str, Any], train: bool = False):
    """The conditioning bundle ``({'features': [B, E], 'context': grid |
    None}, new_bn_stats)``.

    Conditional: one encoder pass over the batch's images (``images``, or
    ``images_u8`` through ``image_norm``); in train mode it moves every
    running statistic once, and ``new_bn_stats`` are the encoder's running
    statistics after it.  A conditional transformer gets the features and
    the cross-attention grid from that one pass
    (``encoder.encode_with_grid``), the LSTM the pooled features only.
    Unconditional: ``<S>``-token embeddings per row and ``None``, for
    either generator."""
    require_ported(config)
    if config.cgan and "backbone_feats" in batch:
        # a frozen backbone's pooled features, cached once per image
        # (data/feature_cache.py): only the trainable head runs
        feats = encoder_lib.project_head(generator.encoder,
                                         batch["backbone_feats"], train)
        return ({"features": feats, "context": None},
                encoder_lib.bn_stats(generator.encoder))
    if config.cgan:
        images = _images(config, batch)
        if config.gen_arch == "transformer":
            feats, grid = encoder_lib.encode_with_grid(
                generator.encoder, images, config, train)
        else:
            feats = encoder_lib.encode(generator.encoder, images, config,
                                       train)
            grid = None
        return ({"features": feats, "context": grid},
                encoder_lib.bn_stats(generator.encoder))
    batch_size = batch["captions"].shape[0]
    return ({"features": start_token_features(config, generator, batch_size),
             "context": None}, None)


def start_token_features(config: Config, generator, batch: int):
    """The ``<S>`` embedding per row, from either generator's table."""
    if config.gen_arch == "lstm":
        return gen_lstm.start_token_features(generator.decoder, batch)
    return gen_tf.start_token_features(generator.decoder, batch)


def generator_sample(generator: gen_lstm.Generator, cond: Dict[str, Any],
                     seq_len: int, pretrain: bool, config: Config,
                     temperature=1.0, seed: int = 0, uniforms=None):
    """Free-running decode → ``(outputs [B, T, V], ids [B, T])``: raw
    logits (``pretrain``) or the soft Gumbel sample with Philox noise
    keyed by ``seed`` or the fed ``uniforms [T, B, V]``, on the LSTM's
    ``decode_route(config)``."""
    require_ported(config)
    if config.gen_arch == "transformer":
        return gen_tf.sample(generator.decoder, cond["features"], seq_len,
                             pretrain, config, temperature, seed, uniforms,
                             context=cond.get("context"))
    return gen_lstm.sample(generator.decoder, cond["features"], seq_len,
                           pretrain, temperature, seed, uniforms,
                           route=decode_route(config))


def generator_mle_outputs(generator: gen_lstm.Generator,
                          cond: Dict[str, Any], captions, config: Config,
                          lengths=None, sample_prob: float = 0.0, coins=None,
                          draw: torch.Generator = None):
    """MLE-phase logits ``[B, T, V]`` (targets = ``captions``).  LSTM, by
    ``--mle-objective``: ``free`` (the reference's free-running pretrain
    sample), ``teacher`` (teacher forcing) or ``scheduled`` (scheduled
    sampling at model-feedback probability ``sample_prob``, its per-step
    coins ``[T, B]`` fed or drawn from ``draw``).  Transformer: the
    parallel causal pass with the keys past each caption's ``lengths``
    masked, whatever ``--mle-objective`` says, cross-attending over
    ``cond["context"]`` when conditional."""
    require_ported(config)
    seq_len = captions.shape[1]
    if config.gen_arch == "transformer":
        return gen_tf.teacher_forced(generator.decoder, cond["features"],
                                     captions, config, lengths=lengths,
                                     context=cond.get("context"))[:, :seq_len]
    dec = generator.decoder
    route = decode_route(config)
    if config.mle_objective == "teacher":
        return gen_lstm.teacher_forced(dec, cond["features"], captions,
                                       plain=route == "plain")[:, :seq_len]
    if config.mle_objective == "scheduled":
        return gen_lstm.scheduled_sample(dec, cond["features"], captions,
                                         sample_prob, coins, draw,
                                         remat=config.scan_remat)
    if config.mle_objective != "free":
        raise ValueError(f"--mle-objective {config.mle_objective!r}: "
                         "expected free, teacher or scheduled")
    logits, _ = gen_lstm.sample(dec, cond["features"], seq_len, True,
                                route=route)
    return logits


def init_discriminator(generator: torch.Generator, config: Config,
                       device="cpu", sweep: bool = True):
    require_ported(config)
    if config.disc_arch == "cnn":
        return disc_cnn.init_discriminator_params(generator, config, device,
                                                  sweep)
    if config.disc_arch == "bilstm":
        return disc_bilstm.init_bilstm_discriminator_params(
            generator, config, device, sweep)
    return disc_tf.init_transformer_discriminator_params(generator, config,
                                                         device, sweep)


def discriminator_apply(params, inp, config: Config, train: bool = False,
                        keep=None, generator=None):
    """Flat logits of soft ``[B, L, V]`` or int ``[B, L]`` input: CNN
    ``[B·R]``, transformer and bilstm ``[B]``, ar_transformer ``[B·L]``.
    ``keep``: the dropout keep mask (CNN ``[B·R, F]``, transformer ``[B,
    d_model]``, ar_transformer ``[B, L, d_model]``, bilstm ``[B, 2H]``)."""
    require_ported(config)
    if config.disc_arch == "bilstm":
        return disc_bilstm.apply(params, inp, config, train, keep, generator)
    if config.disc_arch == "transformer":
        return disc_tf.apply(params, inp, config, train, keep, generator)
    if config.disc_arch == "ar_transformer":
        return disc_tf.apply_autoregressive(params, inp, config, train, keep,
                                            generator)
    return disc_cnn.apply(params, inp, config, train, keep, generator)


def disc_keep_shape(config: Config, batch: int):
    """The shape of one discriminator pass's dropout keep mask."""
    if config.disc_arch == "cnn":
        return (batch * config.disc_num_rep, config.disc_feature_dim)
    if config.disc_arch == "ar_transformer":
        return (batch, config.seq_len, config.disc_hidden_dim)
    if config.disc_arch == "bilstm":
        return (batch, 2 * config.disc_hidden_dim)
    return (batch, config.disc_hidden_dim)


def disc_logits_per_sample(config: Config) -> int:
    """How many logits each sample contributes: ``num_rep`` for the CNN,
    ``seq_len`` for ar_transformer, 1 for transformer and bilstm."""
    require_ported(config)
    if config.disc_arch == "cnn":
        return config.disc_num_rep
    if config.disc_arch == "ar_transformer":
        return config.seq_len
    return 1
