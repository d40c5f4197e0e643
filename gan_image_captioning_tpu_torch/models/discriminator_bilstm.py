"""Bidirectional-LSTM discriminator
(``gan_image_captioning_tpu/models/discriminator_bilstm.py``,
``--disc-arch bilstm``).

Token embedding (a gather for int ids, a product for soft input; bias-free
``embeddings.w [Ed, V]``) → ``disc_num_layers``-deep forward and backward
LSTM stacks over the sequence (``lstm.bilstm_forward``: each direction one
teacher-forced pass, whose backward runs the reverse BPTT kernel on CUDA
tensors) → ``[B, T, 2H]`` → max over time → dropout(0.2) → ``Linear(2H →
1)``: one logit per sequence ``[B]``.

:class:`BiLSTMDiscriminator` holds the JAX tree under its names
(``embeddings.w``, ``fwd.{k}.w_ih`` / ``w_hh`` / ``b_ih`` / ``b_hh``, the
same under ``bwd``, ``head.w [2H, 1]`` / ``head.b``), so ``interop`` only
flattens; the compute is functional over a flat parameter dict, so the
adversarial step can run the generator's pass with detached parameters.
Dropout keeps the entries of a fed ``keep [B, 2H]`` mask (the JAX
package's Bernoulli(0.8) draw) or of one drawn from ``generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config, decode_route
from gan_image_captioning_tpu_torch.models.discriminator_transformer import (
    DROPOUT, _dropout, embed_tokens)
from gan_image_captioning_tpu_torch.models.lstm import bilstm_forward
from gan_image_captioning_tpu_torch.models.transformer import (
    Dense, dense, init_dense_, new_param, normal_init_)
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree


class _LstmLayer(nn.Module):
    """One layer's ``w_ih [4H, in]``, ``w_hh [4H, H]``, ``b_ih``, ``b_hh``
    (torch layout, the JAX names)."""

    def __init__(self, in_dim: int, hidden: int, **kw):
        super().__init__()
        self.w_ih = new_param(4 * hidden, in_dim, **kw)
        self.w_hh = new_param(4 * hidden, hidden, **kw)
        self.b_ih = new_param(4 * hidden, **kw)
        self.b_hh = new_param(4 * hidden, **kw)


class BiLSTMDiscriminator(nn.Module):
    """The JAX ``init_bilstm_discriminator_params`` tree, allocated
    uninitialized."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d_emb, hidden = config.disc_embed_dim, config.disc_hidden_dim
        self.embeddings = nn.Module()
        self.embeddings.w = new_param(d_emb, config.vocab_size, **kw)
        for side in ("fwd", "bwd"):
            setattr(self, side, nn.ModuleList(
                _LstmLayer(d_emb if k == 0 else hidden, hidden, **kw)
                for k in range(config.disc_num_layers)))
        self.head = Dense(2 * hidden, 1, **kw)


@torch.no_grad()
def init_bilstm_discriminator_params(generator: torch.Generator,
                                     config: Config, device="cpu",
                                     sweep: bool = True
                                     ) -> BiLSTMDiscriminator:
    """The JAX distributions (drawn on the CPU from ``generator``):
    embeddings N(0, 1)·0.02, both stacks torch's default U(-k, k) with k =
    1/sqrt(H), the head N(0, 1)/sqrt(2H) and a zero bias; then (``sweep``)
    the reference's init sweep (``config.disc_init``)."""
    disc = BiLSTMDiscriminator(config, device)
    normal_init_(generator, disc.embeddings.w, 0.02)
    k = 1.0 / math.sqrt(config.disc_hidden_dim)
    for side in (disc.fwd, disc.bwd):
        for p in side.parameters():
            p.copy_(torch.empty(p.shape, dtype=p.dtype).uniform_(
                -k, k, generator=generator))
    init_dense_(generator, disc.head)
    if sweep:
        init_param_tree(generator, disc, config.disc_init)
    return disc


def _layers(params, side: str):
    """The per-layer ``{w_ih, w_hh, b_ih, b_hh}`` of the ``side`` stack."""
    out, k = [], 0
    while f"{side}.{k}.w_ih" in params:
        out.append({n: params[f"{side}.{k}.{n}"]
                    for n in ("w_ih", "w_hh", "b_ih", "b_hh")})
        k += 1
    return out


def apply_embedded(params, emb, config: Config, train: bool = False,
                   keep=None, generator=None, dropout_rate: float = DROPOUT,
                   plain: bool = False):
    """Logits ``[N]`` from embeddings ``[N, L, Ed]``: both stacks, max over
    time, dropout (``keep [N, 2H]``), the head.  ``plain``: the reverse
    BPTT kernel's plain version on any device."""
    feats = bilstm_forward(_layers(params, "fwd"), _layers(params, "bwd"),
                           emb, plain=plain)                 # [N, L, 2H]
    pooled = feats.max(dim=1).values
    pooled = _dropout(pooled, train, keep, generator, dropout_rate)
    return dense(params, "head", pooled)[:, 0]


def apply(params, inp, config: Config, train: bool = False, keep=None,
          generator=None, dropout_rate: float = DROPOUT):
    """Sequence-level logits ``[B]`` of soft ``[B, L, V]`` or int ``[B,
    L]`` input; the plain BPTT under the ``plain`` decode route."""
    return apply_embedded(params, embed_tokens(params, inp), config, train,
                          keep, generator, dropout_rate,
                          plain=decode_route(config) == "plain")
