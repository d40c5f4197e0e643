"""Architecture dispatch (``gan_image_captioning_tpu/models/api.py``).

Only the unconditional LSTM generator is ported; :func:`require_ported`
turns any other configuration away at startup.
"""

from __future__ import annotations

from typing import Any, Dict

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models import generator as gen_lstm


def require_ported(config: Config) -> None:
    """Raise for a configuration whose path is not ported yet."""
    if config.cgan:
        raise NotImplementedError(
            "--conditional-gan 1: the conditional image encoder is not "
            "ported yet")
    if config.gen_arch != "lstm":
        raise NotImplementedError(
            f"--gen-arch {config.gen_arch}: only the LSTM generator is "
            "ported yet")


def generator_condition(config: Config, generator: gen_lstm.Generator,
                        batch: Dict[str, Any], train: bool = False):
    """Unconditional conditioning bundle ``({'features': [B, E],
    'context': None}, None)`` — ``<S>``-token embeddings per row."""
    require_ported(config)
    batch_size = batch["captions"].shape[0]
    return ({"features": gen_lstm.start_token_features(generator.decoder,
                                                       batch_size),
             "context": None}, None)


def generator_sample(generator: gen_lstm.Generator, cond: Dict[str, Any],
                     seq_len: int, pretrain: bool, config: Config):
    """Free-running decode → ``(outputs [B, T, V], ids [B, T])``."""
    require_ported(config)
    return gen_lstm.sample(generator.decoder, cond["features"], seq_len,
                           pretrain)
