"""Architecture dispatch (``gan_image_captioning_tpu/models/api.py``).

Only the LSTM generator (unconditional, or conditional on the ResNet-18
encoder) and the CNN discriminator are ported; :func:`require_ported`
turns any other configuration away.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.kernels.image_norm import (
    normalize_images, normalize_images_plain)
from gan_image_captioning_tpu_torch.models import discriminator as disc_cnn
from gan_image_captioning_tpu_torch.models import encoder as encoder_lib
from gan_image_captioning_tpu_torch.models import generator as gen_lstm


def require_ported(config: Config, disc: bool = False) -> None:
    """Raise for a configuration whose path is not ported yet (``disc``:
    the discriminator's too)."""
    if config.cgan and config.encoder_arch != "resnet18":
        raise NotImplementedError(
            f"--encoder-arch {config.encoder_arch}: only the ResNet-18 "
            "encoder is ported yet")
    if config.gen_arch != "lstm":
        raise NotImplementedError(
            f"--gen-arch {config.gen_arch}: only the LSTM generator is "
            "ported yet")
    if disc and config.disc_arch != "cnn":
        raise NotImplementedError(
            f"--disc-arch {config.disc_arch}: only the CNN discriminator is "
            "ported yet")


def _plain_decode(config: Config) -> bool:
    if config.decode_impl not in ("kernel", "plain"):
        raise ValueError(f"decode_impl {config.decode_impl!r}: expected "
                         "'kernel' or 'plain'")
    return config.decode_impl == "plain"


def _images(config: Config, batch: Dict[str, Any]):
    """The batch's float32 images: ``images``, or ``images_u8`` normalized
    on the device (the ``image_norm`` kernel, or its plain version under
    ``image_norm_impl="plain"``)."""
    if "backbone_feats" in batch:
        raise NotImplementedError("cached backbone features "
                                  "(--cache-features) are not ported yet")
    if "images_u8" in batch:
        if config.dtype != "float32":
            raise NotImplementedError(f"--dtype {config.dtype}: only float32 "
                                      "images are ported yet")
        if config.image_norm_impl not in ("kernel", "plain"):
            raise ValueError(f"image_norm_impl {config.image_norm_impl!r}: "
                             "expected 'kernel' or 'plain'")
        norm = (normalize_images_plain if config.image_norm_impl == "plain"
                else normalize_images)
        return norm(batch["images_u8"])
    return batch["images"]


def generator_condition(config: Config, generator: gen_lstm.Generator,
                        batch: Dict[str, Any], train: bool = False):
    """The conditioning bundle ``({'features': [B, E], 'context': None},
    new_bn_stats)``.

    Conditional: one encoder pass over the batch's images (``images``, or
    ``images_u8`` through ``image_norm``); in train mode it moves every
    running statistic once, and ``new_bn_stats`` are the encoder's running
    statistics after it.  Unconditional: ``<S>``-token embeddings per row
    and ``None``."""
    require_ported(config)
    if config.cgan:
        feats = encoder_lib.encode(generator.encoder, _images(config, batch),
                                   config, train)
        return ({"features": feats, "context": None},
                encoder_lib.bn_stats(generator.encoder))
    batch_size = batch["captions"].shape[0]
    return ({"features": gen_lstm.start_token_features(generator.decoder,
                                                       batch_size),
             "context": None}, None)


def generator_sample(generator: gen_lstm.Generator, cond: Dict[str, Any],
                     seq_len: int, pretrain: bool, config: Config,
                     temperature=1.0, seed: int = 0, uniforms=None):
    """Free-running decode → ``(outputs [B, T, V], ids [B, T])``: raw
    logits (``pretrain``) or the soft Gumbel sample with Philox noise
    keyed by ``seed`` or the fed ``uniforms [T, B, V]``."""
    require_ported(config)
    return gen_lstm.sample(generator.decoder, cond["features"], seq_len,
                           pretrain, temperature, seed, uniforms,
                           plain=_plain_decode(config))


def generator_mle_outputs(generator: gen_lstm.Generator,
                          cond: Dict[str, Any], captions, config: Config):
    """MLE-phase logits ``[B, T, V]`` (targets = ``captions``), by
    ``--mle-objective``: ``free`` (the reference's free-running pretrain
    sample) or ``teacher`` (teacher forcing)."""
    require_ported(config)
    seq_len = captions.shape[1]
    dec = generator.decoder
    if config.mle_objective == "teacher":
        return gen_lstm.teacher_forced(dec, cond["features"],
                                       captions)[:, :seq_len]
    if config.mle_objective != "free":
        raise NotImplementedError(f"--mle-objective {config.mle_objective}"
                                  " is not ported yet")
    logits, _ = gen_lstm.sample(dec, cond["features"], seq_len, True,
                                plain=_plain_decode(config))
    return logits


def init_discriminator(generator: torch.Generator, config: Config,
                       device="cpu", sweep: bool = True):
    require_ported(config, disc=True)
    return disc_cnn.init_discriminator_params(generator, config, device,
                                              sweep)


def discriminator_apply(params, inp, config: Config, train: bool = False,
                        keep=None, generator=None):
    """Logits ``[B·R]`` of soft ``[B, L, V]`` or int ``[B, L]`` input."""
    require_ported(config, disc=True)
    if config.disc_engine not in ("mxu", "plain"):
        raise ValueError(f"disc_engine {config.disc_engine!r}: expected "
                         "'mxu' or 'plain'")
    return disc_cnn.apply(params, inp, config, train, keep, generator)


def disc_logits_per_sample(config: Config) -> int:
    """How many logits each sample contributes: ``num_rep`` for the CNN."""
    require_ported(config, disc=True)
    return config.disc_num_rep
