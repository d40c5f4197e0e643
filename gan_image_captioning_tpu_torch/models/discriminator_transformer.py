"""Transformer discriminators
(``gan_image_captioning_tpu/models/discriminator_transformer.py``).

* :func:`apply` (``--disc-arch transformer``): token embedding (a gather
  for int ids, a product for soft input) → ``in_proj`` to ``d_model`` →
  positions → self-attention blocks (full mask) → ``ln_f`` → mean pool
  (masked by ``lengths`` when given) → dropout(0.2) → ``head``: one logit
  per sequence ``[B]``.
* :func:`apply_autoregressive` (``ar_transformer``): the same trunk with a
  causal mask and dropout on every position, one logit per prefix
  ``[B · L]``.

:class:`TransformerDiscriminator` holds the JAX tree under its names
(``embeddings.w [Ed, V]``, ``in_proj.w [Ed, d_model]``, ``pos [L,
d_model]``, ``blocks.{i}.*`` without cross-attention, ``ln_f``, ``head``);
the compute is functional over a flat parameter dict, so the adversarial
step can run the generator's pass with detached parameters.  The blocks'
self-attention takes the flash kernels under ``config.attn_impl ==
"kernel"``; ``config.tf_remat`` checkpoints each block.  Dropout keeps the entries of a fed ``keep`` mask (the JAX
package's Bernoulli(0.8) draw) or of one drawn from ``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.discriminator import dropout_keep
from gan_image_captioning_tpu_torch.models.transformer import (
    Block, Dense, LayerNorm, dense, init_blocks_, layer_norm, new_param,
    normal_init_, remat_block_apply)
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree

DROPOUT = 0.2


class TransformerDiscriminator(nn.Module):
    """The JAX ``init_transformer_discriminator_params`` tree, allocated
    uninitialized."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d_emb, d_model = config.disc_embed_dim, config.disc_hidden_dim
        self.embeddings = nn.Module()
        self.embeddings.w = new_param(d_emb, config.vocab_size, **kw)
        self.in_proj = Dense(d_emb, d_model, **kw)
        self.pos = new_param(config.seq_len, d_model, **kw)
        self.blocks = nn.ModuleList(Block(d_model, 2 * d_model, **kw)
                                    for _ in range(config.disc_num_layers))
        self.ln_f = LayerNorm(d_model, **kw)
        self.head = Dense(d_model, 1, **kw)


@torch.no_grad()
def init_transformer_discriminator_params(generator: torch.Generator,
                                          config: Config, device="cpu",
                                          sweep: bool = True
                                          ) -> TransformerDiscriminator:
    """The JAX distributions (embeddings and positions N(0, 1)·0.02, dense
    layers N(0, 1)/sqrt(d_in), layer norms 1 and 0), then (``sweep``) the
    reference's init sweep (``config.disc_init``)."""
    disc = TransformerDiscriminator(config, device)
    init_blocks_(generator, disc)
    normal_init_(generator, disc.embeddings.w, 0.02)
    normal_init_(generator, disc.pos, 0.02)
    if sweep:
        init_param_tree(generator, disc, config.disc_init)
    return disc


def embed_tokens(params, inp):
    """``[B, L, Ed]``: ``W.T[ids]`` for int ids, ``inp @ W.T`` for soft
    ``[B, L, V]`` input."""
    w = params["embeddings.w"]                             # [Ed, V]
    if not torch.is_floating_point(inp):
        return w.T[inp.long()]
    return inp @ w.T


def trunk_embedded(params, emb, config: Config, causal: bool, lengths=None):
    """The trunk from embeddings ``[N, L, Ed]`` → ``[N, L, d_model]``."""
    x = dense(params, "in_proj", emb)
    t = x.shape[1]
    x = x + params["pos"][:t]
    mask = None
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=x.device))[None, None]
    if lengths is not None:
        lengths = lengths.to(x.device)
        key_ok = (torch.arange(t, device=x.device)[None, :]
                  < lengths[:, None])[:, None, None, :]
        mask = key_ok if mask is None else mask & key_ok
    for i in range(config.disc_num_layers):
        x = remat_block_apply(params, f"blocks.{i}", x,
                              config.disc_num_heads, mask,
                              flash_causal=causal, flash_lengths=lengths,
                              attn_impl=config.attn_impl,
                              remat=config.tf_remat)
    return layer_norm(params, "ln_f", x)


def _dropout(x, train, keep, generator, dropout_rate):
    """Inverted dropout; the keep probability in x's dtype, as the JAX
    package's weakly typed constant (bfloat16 0.80078125 under ``--dtype
    bfloat16``)."""
    if not (train and dropout_rate > 0.0):
        return x
    if keep is None:
        keep = dropout_keep(x.shape, generator, x.device, dropout_rate)
    return torch.where(keep, x / torch.tensor(1.0 - dropout_rate,
                                              dtype=x.dtype),
                       torch.zeros((), device=x.device, dtype=x.dtype))


def apply(params, inp, config: Config, train: bool = False, keep=None,
          generator=None, dropout_rate: float = DROPOUT, lengths=None):
    """Sequence-level logits ``[B]`` (bidirectional).  ``keep [B,
    d_model]``: the dropout keep mask of the pooled features."""
    x = trunk_embedded(params, embed_tokens(params, inp), config, False,
                       lengths)
    if lengths is not None:
        t = x.shape[1]
        m = (torch.arange(t, device=x.device)[None, :]
             < lengths.to(x.device)[:, None]).to(x.dtype)
        pooled = (x * m[..., None]).sum(dim=1) / torch.clamp(
            m.sum(dim=1, keepdim=True), min=1.0)
    else:
        pooled = x.mean(dim=1)
    pooled = _dropout(pooled, train, keep, generator, dropout_rate)
    return dense(params, "head", pooled)[:, 0]


def apply_autoregressive(params, inp, config: Config, train: bool = False,
                         keep=None, generator=None,
                         dropout_rate: float = DROPOUT, lengths=None):
    """Per-prefix logits ``[B · L]`` (causal).  ``keep [B, L, d_model]``."""
    x = trunk_embedded(params, embed_tokens(params, inp), config, True,
                       lengths)
    x = _dropout(x, train, keep, generator, dropout_rate)
    return dense(params, "head", x)[..., 0].reshape(-1)
