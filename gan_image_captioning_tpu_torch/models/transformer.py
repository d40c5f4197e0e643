"""Transformer building blocks and the transformer caption generator
(``gan_image_captioning_tpu/models/transformer.py``).

Pre-LN blocks (self-attention, then a tanh-GELU MLP, each with a residual),
learned positional embeddings, the feature vector prepended as the t = 0
token.  Layout: the modules keep the JAX package's parameter tree under the
same names — a dense layer is ``w [in, out]`` and ``b [out]`` applied as
``x @ w + b`` (not ``nn.Linear``'s ``[out, in]``), a layer norm ``scale`` /
``bias``, the embedding ``embed [V, d]``, the output projection ``linear.w
[V, d]`` / ``linear.b`` — so ``state_dict`` keys are the JAX paths
(``decoder.blocks.0.attn.wq.w`` …) and ``interop`` only flattens.  The
compute is functional over a flat ``{name: tensor}`` dict (``params_of``),
as the CNN discriminator's is.

* :func:`teacher_forced` is the parallel causal pass (the MLE mode); with
  ``lengths``, key positions past ``1 + length`` are masked too.
* :func:`decode_step_slots` is the continuous engine's step: a position
  per row over a fixed ``[layers, N, T + 1, heads, head_dim]`` cache.
* :func:`decode_step` / :func:`sample` are the incremental decode over a KV
  cache; ``sample`` gives raw logits and argmax ids (``pretrain``) or the
  Gumbel-softmax sample (``ops/gumbel.py``; its fused kernel unless
  ``decode_impl="plain"``).

Self-attention in :func:`block_apply` goes through the flash kernels
(``kernels/flash_attention.py``) when the caller declares the mask's
structure (``flash_causal``), ``config.attn_impl`` is ``"kernel"`` and the
shape is eligible; otherwise through the dense :func:`attention` (mask fill
``finfo.min``).  The cache decode stays dense, as in the JAX package.

Conditional transformer (``--conditional-gan 1``): the generator holds the
image encoder, whose pooled features are the t = 0 token and whose grid
(``encoder.encode_with_grid``: the ResNet's ``[B, h·w, 512]``, the ViT's
``[B, P, 768]``) is the ``context`` every block cross-attends over after
its self-attention (``ln_cross``, ``cross``; dense, no mask).  The JAX
shape rule for ``ctx_proj`` is kept: the context goes through
``ctx_proj`` only when its width differs from the features' (so config5's
768-wide ViT grid skips it, and its ``ctx_proj`` gets zero gradients,
while the ResNet grid at a 256-wide transformer takes it).  The cache
decode projects the context's keys and values once per decode
(:func:`cross_kv`), not at every step as the JAX scan does: the same
products of the same operands.
Context parallelism, pipelining, activation sharding and ``GIC_TF_REMAT``
are not ported either.

Under ``--dtype bfloat16`` (``train/steps.py:compute_cast``) every
operation runs in bfloat16 as the JAX package's does: the flash kernels'
bfloat16 instantiations (float32 inside, outputs rounded once), the dense
attention's scores rounded before the softmax, the layer norms' mean and
variance reduced in float32 and rounded once, and the KV cache in the
features' dtype.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import START
from gan_image_captioning_tpu_torch.kernels.flash_attention import (
    flash_attention, supported)
from gan_image_captioning_tpu_torch.kernels.gumbel_sample import (
    step_uniforms)
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.ops.gumbel import (gumbel_softmax,
                                                       use_fused_sampler)
from gan_image_captioning_tpu_torch.ops.initializers import init_param_tree


# --------------------------------------------------------------- modules

def new_param(*shape, **kw):
    return nn.Parameter(torch.empty(shape, **kw))


class Dense(nn.Module):
    """``x @ w + b`` with ``w [d_in, d_out]``."""

    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.w = new_param(d_in, d_out, **kw)
        self.b = new_param(d_out, **kw)


class LayerNorm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.scale = new_param(d, **kw)
        self.bias = new_param(d, **kw)


class Attention(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.wq, self.wk = Dense(d, d, **kw), Dense(d, d, **kw)
        self.wv, self.wo = Dense(d, d, **kw), Dense(d, d, **kw)


class MLP(nn.Module):
    def __init__(self, d, d_mlp, **kw):
        super().__init__()
        self.fc1, self.fc2 = Dense(d, d_mlp, **kw), Dense(d_mlp, d, **kw)


class Block(nn.Module):
    """``ln1, attn, ln2, mlp`` (+ ``ln_cross, cross`` when ``cross``)."""

    def __init__(self, d, d_mlp, cross: bool = False, **kw):
        super().__init__()
        self.ln1, self.attn = LayerNorm(d, **kw), Attention(d, **kw)
        self.ln2, self.mlp = LayerNorm(d, **kw), MLP(d, d_mlp, **kw)
        if cross:
            self.ln_cross, self.cross = LayerNorm(d, **kw), Attention(d, **kw)


class Projection(nn.Module):
    """The output projection, torch layout as in the JAX tree: ``w [V, d]``,
    ``b [V]``, applied as ``x @ w.T + b``."""

    def __init__(self, d, V, **kw):
        super().__init__()
        self.w = new_param(V, d, **kw)
        self.b = new_param(V, **kw)


class TransformerDecoder(nn.Module):
    """The JAX ``init_transformer_decoder_params`` tree: ``embed``, ``pos
    [T + 1, d]``, ``ctx_proj``, ``blocks`` (with cross-attention),
    ``ln_f``, ``linear``.  Parameters are allocated uninitialized."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        from gan_image_captioning_tpu_torch.models.encoder import feature_dim

        kw = dict(device=device, dtype=dtype)
        d, d_mlp, V = (config.gen_embed_dim, config.gen_hidden_dim,
                       config.vocab_size)
        self.embed = new_param(V, d, **kw)
        self.pos = new_param(config.seq_len + 1, d, **kw)
        self.ctx_proj = Dense(feature_dim(config), d, **kw)
        self.blocks = nn.ModuleList(Block(d, d_mlp, cross=True, **kw)
                                    for _ in range(config.gen_num_layers))
        self.ln_f = LayerNorm(d, **kw)
        self.linear = Projection(d, V, **kw)


class TransformerGenerator(nn.Module):
    """The decoder under ``decoder``, and the image encoder under
    ``encoder`` when the configuration is conditional, else None."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32):
        super().__init__()
        from gan_image_captioning_tpu_torch.models.encoder import Encoder

        self.decoder = TransformerDecoder(config, device, dtype)
        self.encoder = Encoder(config, device, dtype) if config.cgan else None


@torch.no_grad()
def init_dense_(generator: torch.Generator, dense: Dense) -> None:
    """The JAX ``_dense_init``: ``w ~ N(0, 1)/sqrt(d_in)``, ``b = 0``."""
    w = dense.w
    w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype)
            / math.sqrt(w.shape[0]))
    dense.b.zero_()


@torch.no_grad()
def init_blocks_(generator: torch.Generator, module: nn.Module) -> None:
    """Every Dense of ``module`` by :func:`init_dense_`, every LayerNorm
    ``scale = 1``, ``bias = 0`` (the JAX ``init_block``)."""
    for sub in module.modules():
        if isinstance(sub, Dense):
            init_dense_(generator, sub)
        elif isinstance(sub, LayerNorm):
            sub.scale.fill_(1.0)
            sub.bias.zero_()


def normal_init_(generator, p, scale):
    p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype) * scale)


@torch.no_grad()
def init_transformer_decoder_params(generator: torch.Generator,
                                    decoder: TransformerDecoder):
    """The JAX distributions (drawn on the CPU from ``generator``):
    embeddings, positions and the projection N(0, 1)·0.02, dense layers
    N(0, 1)/sqrt(d_in), layer norms 1 and 0, biases 0."""
    init_blocks_(generator, decoder)
    normal_init_(generator, decoder.embed, 0.02)
    normal_init_(generator, decoder.pos, 0.02)
    normal_init_(generator, decoder.linear.w, 0.02)
    decoder.linear.b.zero_()
    return decoder


def init_transformer_generator_params(generator: torch.Generator,
                                      config: Config, device="cpu",
                                      sweep: bool = True
                                      ) -> TransformerGenerator:
    """A seeded transformer generator (with its encoder when
    conditional); ``sweep`` applies the reference's init sweep
    (``config.gen_init``) over every parameter, the encoder's too, as the
    JAX package does."""
    from gan_image_captioning_tpu_torch.models.encoder import (
        init_encoder_params)

    gen = TransformerGenerator(config, device)
    init_transformer_decoder_params(generator, gen.decoder)
    if gen.encoder is not None:
        init_encoder_params(generator, gen.encoder)
    if sweep:
        init_param_tree(generator, gen, config.gen_init)
    return gen


# ------------------------------------------------------------- functions

def dense(p, name: str, x):
    return x @ p[name + ".w"] + p[name + ".b"]


def layer_norm(p, name: str, x, eps: float = 1e-5):
    """Population variance, eps 1e-5 (the JAX ``layer_norm``).  In
    bfloat16 the mean and the variance reduce in float32 and are rounded
    once, as ``jnp.mean`` and ``jnp.var`` do; the rest rounds at each
    operation."""
    if x.dtype == torch.bfloat16:
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True).to(x.dtype)
        var = xf.var(dim=-1, keepdim=True, correction=0).to(x.dtype)
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p[name + ".scale"] \
        + p[name + ".bias"]


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _split_heads(x, n_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _dense_core(q, k, v, mask):
    """softmax(QKᵀ/√D)V; ``mask`` True = attend, the rest filled with the
    dtype's most negative value.  In bfloat16 the scores are rounded and
    then divided by √D rounded to bfloat16, as the JAX package's weakly
    typed constant is."""
    root = math.sqrt(q.shape[-1])
    if q.dtype == torch.bfloat16:
        root = torch.tensor(root, dtype=q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def attention(p, name: str, x_q, x_kv, n_heads: int, mask=None):
    """Dense multi-head attention; ``mask`` broadcastable to
    ``[B, heads, Tq, Tkv]``, True = attend."""
    q = _split_heads(dense(p, name + ".wq", x_q), n_heads)
    k = _split_heads(dense(p, name + ".wk", x_kv), n_heads)
    v = _split_heads(dense(p, name + ".wv", x_kv), n_heads)
    out = _dense_core(q, k, v, mask)
    b, t = x_q.shape[:2]
    return dense(p, name + ".wo", out.reshape(b, t, -1))


def _flash_applicable(x, n_heads: int, attn_impl: str) -> bool:
    if attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl {attn_impl!r}: expected 'kernel' or "
                         "'plain'")
    return attn_impl == "kernel" and supported(x.shape[1],
                                               x.shape[2] // n_heads)


def _flash_attention_block(p, name: str, x, n_heads: int, causal: bool,
                           lengths=None):
    """Self-attention whose softmax(QKᵀ)V core is the flash kernel (the
    projections stay products)."""
    q = _split_heads(dense(p, name + ".wq", x), n_heads)
    k = _split_heads(dense(p, name + ".wk", x), n_heads)
    v = _split_heads(dense(p, name + ".wv", x), n_heads)
    out = flash_attention(q, k, v, causal, lengths)
    b, t = x.shape[:2]
    return dense(p, name + ".wo", out.reshape(b, t, -1))


def block_apply(p, name: str, x, n_heads: int, mask=None,
                flash_causal: Optional[bool] = None, flash_lengths=None,
                attn_impl: str = "kernel", context=None):
    """Pre-LN block ``name`` (``"blocks.{i}"``): self-attention →
    cross-attention over ``context [B, P, d]`` (when given; dense, no
    mask) → MLP, residual each.  ``flash_causal`` / ``flash_lengths``
    declare the self-attention mask as (causal | full) ∧ (key < length),
    the flash kernels' three forms; None = an arbitrary mask, dense
    only."""
    h1 = layer_norm(p, name + ".ln1", x)
    if flash_causal is not None and _flash_applicable(x, n_heads, attn_impl):
        x = x + _flash_attention_block(p, name + ".attn", h1, n_heads,
                                       flash_causal, flash_lengths)
    else:
        x = x + attention(p, name + ".attn", h1, h1, n_heads, mask)
    if context is not None:
        x = x + attention(p, name + ".cross",
                          layer_norm(p, name + ".ln_cross", x), context,
                          n_heads)
    h = layer_norm(p, name + ".ln2", x)
    return x + dense(p, name + ".mlp.fc2", gelu(dense(p, name + ".mlp.fc1",
                                                      h)))


def causal_mask(t: int, device="cpu"):
    """Lower-triangular ``[1, 1, T, T]`` attend-mask."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=device))[None, None]


def num_blocks(p) -> int:
    n = 0
    while f"blocks.{n}.ln1.scale" in p:
        n += 1
    return n


def _project(p, x):
    return x @ p["linear.w"].T + p["linear.b"]


def project_context(p, context, d: int):
    """The JAX shape rule: ``context`` through ``ctx_proj`` when its width
    is not the model width ``d``, else as it is (None stays None)."""
    if context is not None and context.shape[-1] != d:
        return dense(p, "ctx_proj", context)
    return context


def teacher_forced(dec, features, captions, config: Config, lengths=None,
                   context=None):
    """Parallel causal pass → logits ``[B, T + 1, V]``: position i of
    ``[features, embed(captions)]`` predicts ``captions[i]``.  With
    ``lengths [B]`` the keys past ``1 + length`` are masked (the flash
    kernels get ``lengths + 1``, as the JAX package passes them).
    ``context [B, P, C]``: the cross-attention grid (:func:`project_context`
    first).  ``dec``: a :class:`TransformerDecoder` or its flat parameter
    dict."""
    p = dec if isinstance(dec, dict) else params_of(dec)
    context = project_context(p, context, features.shape[-1])
    x = torch.cat([features[:, None, :], p["embed"][captions.long()]], dim=1)
    t = x.shape[1]
    x = x + p["pos"][:t]
    mask = causal_mask(t, x.device)
    flash_lengths = None
    if lengths is not None:
        lengths = lengths.to(x.device)
        key_ok = (torch.arange(t, device=x.device)[None, :]
                  < (lengths + 1)[:, None])
        mask = mask & key_ok[:, None, None, :]
        flash_lengths = lengths + 1
    for i in range(num_blocks(p)):
        x = block_apply(p, f"blocks.{i}", x, config.gen_num_heads, mask,
                        flash_causal=True, flash_lengths=flash_lengths,
                        attn_impl=config.attn_impl, context=context)
    return _project(p, layer_norm(p, "ln_f", x))


def _init_kv_cache(config: Config, batch: int, dtype=torch.float32,
                   device="cpu"):
    """An empty cache: per layer ``[N, 0, heads, head_dim]`` keys and
    values, grown by one position per :func:`decode_step`.  (The JAX
    package keeps a fixed ``[L, N, T + 1, heads, head_dim]`` buffer and
    masks the positions not yet written; a growing cache attends over
    exactly the positions written, and stays differentiable.)"""
    h = config.gen_num_heads
    shape = (batch, 0, h, config.gen_embed_dim // h)
    empty = torch.zeros(shape, dtype=dtype, device=device)
    return ([empty] * config.gen_num_layers, [empty] * config.gen_num_layers)


def cross_kv(dec, context, n_heads: int):
    """Per block, the cross-attention's keys and values ``[N, P, heads,
    head_dim]`` of a projected ``context`` (None without one): what every
    decode step attends over."""
    if context is None:
        return None
    p = dec if isinstance(dec, dict) else params_of(dec)
    return [(_split_heads(dense(p, f"blocks.{i}.cross.wk", context), n_heads),
             _split_heads(dense(p, f"blocks.{i}.cross.wv", context), n_heads))
            for i in range(num_blocks(p))]


def decode_step(dec, config: Config, x_tok, k_cache: List, v_cache: List,
                t: int, cross=None):
    """One incremental decode step: ``x_tok [N, d]`` at position ``t``
    (the features at t = 0) over the cache of positions ``< t`` → ``(logits
    [N, V], new_k, new_v)``.  ``cross``: :func:`cross_kv` of the context,
    attended after each block's self-attention."""
    p = dec if isinstance(dec, dict) else params_of(dec)
    n_heads = config.gen_num_heads
    batch = x_tok.shape[0]
    x = (x_tok + p["pos"][t])[:, None, :]                  # [N, 1, d]
    new_k, new_v = [], []
    for li in range(len(k_cache)):
        name = f"blocks.{li}"
        h_in = layer_norm(p, name + ".ln1", x)
        q = _split_heads(dense(p, name + ".attn.wq", h_in), n_heads)
        k_l = torch.cat([k_cache[li], _split_heads(
            dense(p, name + ".attn.wk", h_in), n_heads)], dim=1)
        v_l = torch.cat([v_cache[li], _split_heads(
            dense(p, name + ".attn.wv", h_in), n_heads)], dim=1)
        new_k.append(k_l)
        new_v.append(v_l)
        att = _dense_core(q, k_l, v_l, None).reshape(batch, 1, -1)
        x = x + dense(p, name + ".attn.wo", att)
        if cross is not None:
            qc = _split_heads(dense(p, name + ".cross.wq", layer_norm(
                p, name + ".ln_cross", x)), n_heads)
            att = _dense_core(qc, *cross[li], None).reshape(batch, 1, -1)
            x = x + dense(p, name + ".cross.wo", att)
        h = layer_norm(p, name + ".ln2", x)
        x = x + dense(p, name + ".mlp.fc2", gelu(dense(p, name + ".mlp.fc1",
                                                        h)))
    logits = _project(p, layer_norm(p, "ln_f", x))[:, 0, :]
    return logits, new_k, new_v


def init_slot_cache(config: Config, batch: int, dtype=torch.float32,
                    device="cpu"):
    """The fixed cache of :func:`decode_step_slots`: keys and values
    ``[layers, N, T + 1, heads, head_dim]`` (the JAX ``_init_kv_cache``),
    zeros."""
    h = config.gen_num_heads
    shape = (config.gen_num_layers, batch, config.seq_len + 1, h,
             config.gen_embed_dim // h)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step_slots(dec, config: Config, x_tok, k_cache, v_cache, t_vec,
                      cross=None):
    """One incremental decode step with a position per row (the JAX
    ``decode_step_slots``, the continuous engine's slot step): row n's
    input ``x_tok[n]`` sits at position ``t_vec[n]``, takes that
    position's embedding, writes its keys and values at ``(n, t_vec[n])``
    of the fixed caches ``[layers, N, T + 1, heads, head_dim]`` (written in
    place) and attends the positions ``<= t_vec[n]``; the rest are filled
    with the dtype's most negative score, as the JAX mask does.  ``cross``:
    per block, the rows' cross-attention keys and values (:func:`cross_kv`
    of each row's projected context, made when the row is admitted).
    Returns ``(logits [N, V], k_cache, v_cache)``.

    A slot's stale positions from an earlier occupant need no zeroing:
    every position a row attends has been written since it was reset to
    t = 0."""
    p = dec if isinstance(dec, dict) else params_of(dec)
    n_heads = config.gen_num_heads
    batch = x_tok.shape[0]
    rows = torch.arange(batch, device=x_tok.device)
    t_vec = t_vec.to(device=x_tok.device, dtype=torch.long)
    x = (x_tok + p["pos"][t_vec])[:, None, :]              # [N, 1, d]
    pos_ok = (torch.arange(k_cache.shape[2], device=x.device)[None, :]
              <= t_vec[:, None])[:, None, None, :]          # [N, 1, 1, L]
    for li in range(k_cache.shape[0]):
        name = f"blocks.{li}"
        h_in = layer_norm(p, name + ".ln1", x)
        q = _split_heads(dense(p, name + ".attn.wq", h_in), n_heads)
        k_cache[li, rows, t_vec] = _split_heads(
            dense(p, name + ".attn.wk", h_in), n_heads)[:, 0]
        v_cache[li, rows, t_vec] = _split_heads(
            dense(p, name + ".attn.wv", h_in), n_heads)[:, 0]
        att = _dense_core(q, k_cache[li], v_cache[li],
                          pos_ok).reshape(batch, 1, -1)
        x = x + dense(p, name + ".attn.wo", att)
        if cross is not None:
            qc = _split_heads(dense(p, name + ".cross.wq", layer_norm(
                p, name + ".ln_cross", x)), n_heads)
            att = _dense_core(qc, *cross[li], None).reshape(batch, 1, -1)
            x = x + dense(p, name + ".cross.wo", att)
        h = layer_norm(p, name + ".ln2", x)
        x = x + dense(p, name + ".mlp.fc2", gelu(dense(p, name + ".mlp.fc1",
                                                        h)))
    logits = _project(p, layer_norm(p, "ln_f", x))[:, 0, :]
    return logits, k_cache, v_cache


def start_token_features(decoder: TransformerDecoder, batch: int):
    """Unconditional-mode t = 0 input: the embedding of ``<S>`` per row."""
    ids = torch.full((batch,), START, dtype=torch.long,
                     device=decoder.embed.device)
    return decoder.embed[ids]


def sample(dec, features, seq_len: int, pretrain: bool = False,
           config: Config = None, temperature=1.0, seed: int = 0,
           uniforms=None, context=None):
    """Free-running decode over the KV cache → ``(outputs [B, T, V], ids
    [B, T])``: per step embed the previous token (+ position), attend over
    the cached prefix, project, then raw logits and their argmax
    (``pretrain``) or the Gumbel-softmax sample of the logits, and feed
    ``embed[ids]`` back.  Gumbel noise: the fed ``uniforms [T, B, V]``, or
    the sampler's draw for ``(seed, t)`` (the fused kernel's Philox on CUDA
    under ``--use-pallas auto`` or ``on``, else
    ``gumbel_sample.step_uniforms``).  The fused sampler is
    :func:`ops.gumbel.use_fused_sampler`'s choice.  ``context``: the
    cross-attention grid (:func:`project_context`, then :func:`cross_kv`
    once)."""
    p = dec if isinstance(dec, dict) else params_of(dec)
    cross = cross_kv(p, project_context(p, context, features.shape[-1]),
                     config.gen_num_heads)
    k_cache, v_cache = _init_kv_cache(config, features.shape[0],
                                      features.dtype, features.device)
    kernel = use_fused_sampler(config)
    x, outs, ids = features, [], []
    for t in range(seq_len):
        logits, k_cache, v_cache = decode_step(p, config, x, k_cache,
                                               v_cache, t, cross)
        if pretrain:
            out, ids_t = logits, torch.argmax(logits, dim=-1)
        else:
            u = uniforms[t] if uniforms is not None else (
                None if kernel else step_uniforms(seed, t, logits.shape,
                                                  logits.device))
            out, ids_t = gumbel_softmax(logits, temperature, u=u,
                                        kernel=kernel, seed=seed, step=t)
        outs.append(out)
        ids.append(ids_t)
        x = p["embed"][ids_t.long()]
    return torch.stack(outs, dim=1), torch.stack(ids, dim=1).to(torch.int32)
