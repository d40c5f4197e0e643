"""LSTM caption decoder (``gan_image_captioning_tpu/models/generator.py``).

:class:`Generator` holds a :class:`Decoder` under ``decoder``, so its
``state_dict`` has the reference's keys (``decoder.embed.weight``,
``decoder.lstm.weight_ih_l{k}``, ``decoder.linear.weight`` …) — the layout
``src/export_torch.py`` writes from a JAX checkpoint.

:func:`sample` is the greedy (``pretrain=True``) branch of the JAX
package's ``_sample_fused``: LSTM step → vocab projection → argmax →
embedding feedback, as a Python loop.  It is the plain reference decode
that the kernel path is held against.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import START
from gan_image_captioning_tpu_torch.models import lstm
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree


class Decoder(nn.Module):
    """Embedding(V, E) + LSTM(E→H, L layers) + Linear(H→V).  Parameters are
    allocated uninitialized; :func:`init_decoder_params` or a checkpoint
    fills them."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        V, E, H = config.vocab_size, config.gen_embed_dim, config.gen_hidden_dim
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.utils.skip_init(nn.Embedding, V, E, **kw)
        self.lstm = lstm.LSTM(E, H, config.gen_num_layers, **kw)
        self.linear = nn.utils.skip_init(nn.Linear, H, V, **kw)


class Generator(nn.Module):
    """The unconditional generator: a decoder only (the conditional image
    encoder is not ported yet)."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        self.decoder = Decoder(config, device, dtype)


@torch.no_grad()
def init_decoder_params(generator: torch.Generator, decoder: Decoder) -> Decoder:
    """The JAX package's ``init_decoder_params`` distributions: embedding
    N(0, 1), torch-default LSTM init, projection N(0, 1)/sqrt(H), zero
    projection bias.  Drawn on the CPU from ``generator``."""
    emb = decoder.embed.weight
    emb.copy_(torch.randn(emb.shape, generator=generator, dtype=emb.dtype))
    lstm.init_lstm_params(generator, decoder.lstm)
    w = decoder.linear.weight
    w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype)
            / math.sqrt(w.shape[1]))
    decoder.linear.bias.zero_()
    return decoder


def init_generator_params(generator: torch.Generator, config: Config,
                          device="cpu", sweep: bool = True) -> Generator:
    """A seeded generator; ``sweep`` applies the reference's init sweep
    (``config.gen_init``) over every parameter, as the JAX package's
    ``init_generator_params`` does."""
    gen = Generator(config, device)
    init_decoder_params(generator, gen.decoder)
    if sweep:
        init_param_tree(generator, gen, config.gen_init)
    return gen


def start_token_features(decoder: Decoder, batch: int):
    """Unconditional-mode t=0 input: the embedding of ``<S>`` per row."""
    w = decoder.embed.weight
    ids = torch.full((batch,), START, dtype=torch.long, device=w.device)
    return w[ids]


@torch.no_grad()
def sample(decoder: Decoder, features, seq_len: int, pretrain: bool = True):
    """Greedy free-running decode → ``(logits [B, T, V], ids [B, T] int32)``.

    Only the ``pretrain`` (no Gumbel noise) branch is ported."""
    if not pretrain:
        raise NotImplementedError("Gumbel-softmax sampling is not ported yet")
    batch = features.shape[0]
    fused = lstm.fuse_layer_params(decoder.lstm.layers())
    state = lstm.zero_state(decoder.lstm.num_layers, batch,
                            decoder.lstm.hidden_dim, features.dtype,
                            features.device)
    w, b = decoder.linear.weight, decoder.linear.bias
    x = features
    outs, ids = [], []
    for _ in range(seq_len):
        h_top, state = lstm.lstm_step(fused, x, state)
        logits = h_top @ w.T + b
        ids_t = torch.argmax(logits, dim=-1)         # first index on ties
        outs.append(logits)
        ids.append(ids_t)
        x = decoder.embed.weight[ids_t]
    return (torch.stack(outs, dim=1),
            torch.stack(ids, dim=1).to(torch.int32))
