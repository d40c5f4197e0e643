"""Greedy caption decoding (``gan_image_captioning_tpu/eval/decode.py``).

:func:`greedy_with_logprobs` is the serving decode: on CUDA tensors it is
one call of the serve-mode decode kernel (greedy ids and per-token
logprobs together); on the CPU it is the plain composition
:func:`greedy` + :func:`sequence_logprob`, as the JAX package does off
the TPU.  Beam search, sampling and the adaptive chunked decode are not
ported yet.
"""

from __future__ import annotations

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import END
from gan_image_captioning_tpu_torch.kernels.decode_sample import decode_sample
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
from gan_image_captioning_tpu_torch.models.generator import (Generator,
                                                            greedy_ids)


@torch.no_grad()
def greedy(generator: Generator, features, config: Config,
           seq_len: int = None):
    """Deterministic greedy decode → ids [B, T] int32."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    return greedy_ids(generator.decoder, features, seq_len)


def kernel_serve_available(features) -> bool:
    """The serve-mode decode kernel runs where the tensors are: on a CUDA
    device."""
    return features.is_cuda


def masked_logprob_sum(ids, lps):
    """Per-sequence greedy log-probability: sum per-token logprobs up to
    and including the FIRST ``<E>`` (``sequence_logprob``'s masking)."""
    is_end = ids == END
    ncum = torch.cumsum(is_end.to(torch.int32), dim=1)
    keep = (ncum == 0) | (is_end & (ncum == 1))
    return torch.where(keep, lps, torch.zeros_like(lps)).sum(dim=1)


@torch.no_grad()
def greedy_with_logprobs(generator: Generator, features, config: Config,
                         seq_len: int = None):
    """``(ids [B, T] int32, seq_logprob [B])``."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    if kernel_serve_available(features):
        dec = generator.decoder
        ids, lps = decode_sample(features, dec.lstm.layers(),
                                 dec.linear.weight, dec.linear.bias,
                                 dec.embed.weight, seq_len, mode="serve")
        return ids, masked_logprob_sum(ids, lps)
    ids = greedy(generator, features, config, seq_len)
    return ids, sequence_logprob(generator, features, ids, config)


@torch.no_grad()
def sequence_logprob(generator: Generator, features, ids, config: Config):
    """Greedy-path log-probability of given token sequences under the
    model, teacher-forcing the ids; positions after the first ``<E>`` do
    not count."""
    api.require_ported(config)
    dec = generator.decoder
    fused = lstm_lib.fuse_layer_params(dec.lstm.layers())
    B, T = ids.shape
    state = lstm_lib.zero_state(dec.lstm.num_layers, B, dec.lstm.hidden_dim,
                                features.dtype, features.device)
    ids_l = ids.to(torch.long)
    x = features
    lps = []
    for t in range(T):
        h_top, state = lstm_lib.lstm_step(fused, x, state)
        logits = h_top @ dec.linear.weight.T + dec.linear.bias
        logp = torch.log_softmax(logits, dim=-1)
        lps.append(logp.gather(1, ids_l[:, t:t + 1])[:, 0])
        x = dec.embed.weight[ids_l[:, t]]
    return masked_logprob_sum(ids, torch.stack(lps, dim=1))
