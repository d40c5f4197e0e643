"""LSTM caption decoder (``gan_image_captioning_tpu/models/generator.py``).

:class:`Generator` holds a :class:`Decoder` under ``decoder`` and, when
conditional, an image :class:`~gan_image_captioning_tpu_torch.models.
encoder.Encoder` under ``encoder``, so its ``state_dict`` has the
reference's keys (``decoder.embed.weight``, ``decoder.lstm.weight_ih_l{k}``,
``decoder.linear.weight``, ``encoder.linear.weight`` …; the backbone under
``encoder.resnet.*`` with torchvision's names, which the checkpoint renames
to the reference's ``nn.Sequential`` numbers).

:func:`sample` is the free-running decode on a route of
``decode_route(config)`` (the JAX package's ``_sample_kernel`` and
``_sample_decoupled``): ``pretrain`` gives greedy ids and their
differentiable teacher-forced logits (the rescore); otherwise

* ``kernel``: :func:`sample_soft`, the Gumbel-softmax sample of the
  ``sample_resid`` decode, whose gradient is the manual residual backward
  of ``_kernel_sample_soft`` through the BPTT chain kernel;
* ``kernel_rescore``: :func:`sample_kernel_rescore`, ids and noise from the
  mode-``sample`` decode, then the rescore (``GIC_KERNEL_VJP=0``);
* ``decoupled``: :func:`sample_decoupled`, a gradient-free loop of PyTorch
  operations, then the rescore;
* ``kernel_embed``: :func:`sample_embed`, the sample already contracted
  into the CNN discriminator's embedding by the ``sample_embed`` decode,
  with the fused-embed backward kernel (``GIC_FUSE_EMBED=1``); the
  adversarial step calls it, every other sample takes ``kernel``.

:func:`teacher_forced` is the reference's ``Decoder.forward``; it and the
rescore backpropagate through the reverse BPTT kernel
(``models/lstm.py:lstm_seq_tm``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import START
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_embed, decode_sample_embed_bwd,
    decode_sample_logits, decode_sample_noise, decode_sample_plain,
    decode_sample_resid, decode_sample_resid_plain, seeded_uniforms)
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_chain_plain)
from gan_image_captioning_tpu_torch.models import encoder as encoder_lib
from gan_image_captioning_tpu_torch.models import lstm
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise
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
    """The decoder, and the image encoder when ``with_encoder`` (by
    default: when the configuration is conditional)."""

    def __init__(self, config: Config, device="cpu", dtype=torch.float32,
                 with_encoder: Optional[bool] = None):
        super().__init__()
        self.decoder = Decoder(config, device, dtype)
        if config.cgan if with_encoder is None else with_encoder:
            self.encoder = encoder_lib.Encoder(config, device, dtype)
        else:
            self.encoder = None


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
                          device="cpu", sweep: bool = True,
                          with_encoder: Optional[bool] = None) -> Generator:
    """A seeded generator; ``sweep`` applies the reference's init sweep
    (``config.gen_init``) over every parameter, as the JAX package's
    ``init_generator_params`` does: the encoder's weights too (BatchNorm
    scales included; the running statistics are buffers, which it does
    not touch)."""
    gen = Generator(config, device, with_encoder=with_encoder)
    init_decoder_params(generator, gen.decoder)
    if gen.encoder is not None:
        encoder_lib.init_encoder_params(generator, gen.encoder)
    if sweep:
        init_param_tree(generator, gen, config.gen_init)
    return gen


def start_token_features(decoder: Decoder, batch: int):
    """Unconditional-mode t=0 input: the embedding of ``<S>`` per row."""
    w = decoder.embed.weight
    ids = torch.full((batch,), START, dtype=torch.long, device=w.device)
    return w[ids]


def _layer_dicts(flat, nl):
    keys = ("w_ih", "w_hh", "b_ih", "b_hh")
    return [dict(zip(keys, flat[4 * l:4 * l + 4])) for l in range(nl)]


def _bptt_from_dhs(features, embed, layers, ids, hs, cs, gates, d_hs,
                   plain: bool = False):
    """The decode backward from the top layer's hidden cotangent ``d_hs
    [T, B, H]`` (the JAX package's ``_lstm_bptt_from_dhs``, shared by the
    soft and the embed-fused sample): the chained BPTT recurrence
    (``lstm_bptt_chain``), the deferred dW/db products, and the layer-0
    input gradient's embedding scatter-add and features gradient.
    Returns ``(d_features, d_embed, [dw_ih, dw_hh, db_ih, db_hh] * NL)``."""
    nl, (T, _, B, H) = len(layers), hs.shape
    w_hhs = torch.stack([lp["w_hh"].T for lp in layers]).contiguous()
    w_ihs = torch.stack([lp["w_ih"].T for lp in layers[1:]]
                        or [w_hhs[0]]).contiguous()
    chain = lstm_bptt_chain_plain if plain else lstm_bptt_chain
    d_pre = chain(w_hhs, w_ihs, d_hs, gates, cs)           # [T, NL, B, 4H]
    ids_tm = ids.T.long()                                  # [T, B]
    xs0 = torch.cat([features[None], embed[ids_tm[:-1]]])  # [T, B, E]
    h_prev = torch.cat([hs.new_zeros(1, nl, B, H), hs[:-1]])
    grads = []
    for l, lp in enumerate(layers):
        xs_l = xs0 if l == 0 else hs[:, l - 1]
        in_dim = xs_l.shape[-1]
        dl = d_pre[:, l].reshape(T * B, 4 * H)
        xh = torch.cat([xs_l, h_prev[:, l]], dim=-1).reshape(T * B, -1)
        dw_f = xh.T @ dl                                   # [in+H, 4H]
        db = dl.sum(dim=0)
        grads += [dw_f[:in_dim].T, dw_f[in_dim:].T, db, db.clone()]

    # layer-0 input path → the embedding scatter and the features
    d_xs0 = d_pre[:, 0] @ layers[0]["w_ih"]                # [T, B, E]
    d_embed = torch.zeros_like(embed).index_add_(
        0, ids_tm[:-1].reshape(-1), d_xs0[1:].reshape(-1, embed.shape[1]))
    return d_xs0[0], d_embed, grads


def _decoder_flat(decoder: Decoder):
    return [t for lp in decoder.lstm.layers()
            for t in (lp["w_ih"], lp["w_hh"], lp["b_ih"], lp["b_hh"])]


class _SampleSoft(torch.autograd.Function):
    """Adversarial soft sample with a manual backward from the decode's
    residuals — the JAX package's ``_kernel_sample_soft``.

    Forward: one ``sample_resid`` decode gives the soft samples, the ids
    and the per-layer h, c and pre-activation gates.  Backward: softmax
    VJP → projection gradients as two products → :func:`_bptt_from_dhs`.
    The argmax feedback carries no gradient, as in the reference
    (``generator.py:75``)."""

    @staticmethod
    def forward(ctx, features, temperature, seed, uniforms, seq_len, plain,
                embed, w_proj, b_proj, *lstm_flat):
        nl = len(lstm_flat) // 4
        layers = _layer_dicts(lstm_flat, nl)
        if plain:
            if uniforms is None:
                uniforms = seeded_uniforms(
                    seed, (seq_len, features.shape[0], embed.shape[0]),
                    features.device)
            ids, soft, hs, cs, gates = decode_sample_resid_plain(
                features, layers, w_proj, b_proj, embed, seq_len, uniforms,
                float(temperature))
        else:
            ids, soft, hs, cs, gates = decode_sample_resid(
                features, layers, w_proj, b_proj, embed, seq_len, seed,
                temperature, uniforms)
        ctx.save_for_backward(features, embed, w_proj, ids, soft, hs, cs,
                              gates, *lstm_flat)
        ctx.temperature, ctx.plain, ctx.nl = float(temperature), plain, nl
        ctx.mark_non_differentiable(ids)
        return soft, ids

    @staticmethod
    def backward(ctx, d_soft, _d_ids):
        features, embed, w_proj, ids, soft, hs, cs, gates, *lstm_flat = (
            ctx.saved_tensors)
        nl, T, B, V = ctx.nl, *soft.shape
        H = hs.shape[-1]

        # softmax VJP: soft = softmax(temp · (logits + g))
        inner = (d_soft * soft).sum(dim=-1, keepdim=True)
        d_logits = (d_soft - inner).mul_(soft).mul_(ctx.temperature)

        # projection: logits = h_top @ W.T + b
        d2 = d_logits.reshape(T * B, V)
        d_w_proj = d2.T @ hs[:, nl - 1].reshape(T * B, H)
        d_b_proj = d2.sum(dim=0)
        d_hs = (d2 @ w_proj).reshape(T, B, H)
        del d_logits, d2

        d_features, d_embed, grads = _bptt_from_dhs(
            features, embed, _layer_dicts(lstm_flat, nl), ids, hs, cs, gates,
            d_hs, ctx.plain)
        return (d_features, None, None, None, None, None, d_embed, d_w_proj,
                d_b_proj, *grads)


def sample_soft(decoder: Decoder, features, seq_len: int, temperature,
                seed: int = 0, uniforms=None, plain: bool = False):
    """Adversarial Gumbel-softmax sample → ``(soft [B, T, V], ids [B, T])``,
    differentiable in the decoder's parameters and ``features``.

    ``uniforms [T, B, V]`` feed the noise; otherwise the decode kernel
    draws it with Philox keyed by ``seed`` (the plain route and the CPU:
    ``torch.rand`` from a generator seeded with ``seed``).  ``plain=True``
    runs the plain versions of the decode and the BPTT kernels on any
    device."""
    soft_tm, ids = _SampleSoft.apply(
        features, float(temperature), int(seed), uniforms, seq_len, plain,
        decoder.embed.weight, decoder.linear.weight, decoder.linear.bias,
        *_decoder_flat(decoder))
    return soft_tm.transpose(0, 1), ids


class _SampleEmbed(torch.autograd.Function):
    """Adversarial sample fused through the discriminator's embedding — the
    JAX package's ``_kernel_sample_embed`` (``GIC_FUSE_EMBED=1``).

    Forward: one ``sample_embed`` decode gives ``emb = soft @ Wd^T``
    ``[T, B, Ed]``, the ids, and the soft sample and residuals it saves.
    It returns ``emb`` twice, as ``emb_gen`` and ``emb_fake``: JAX runs the
    forward once per side (``wrt="gen"`` and ``wrt="disc"``), the port's
    single backward needs both roles from one forward.  The cotangent of
    ``emb_gen`` reaches the generator and the features only
    (``decode_sample_embed_bwd``, then :func:`_bptt_from_dhs`); that of
    ``emb_fake`` reaches ``Wd`` only (``dWd = d_emb^T @ soft``, a product
    outside the kernel in JAX too).  That is the detach contract of the
    JAX step at the embedding level: the fake pass carries no generator
    gradient, the generator pass no discriminator one."""

    @staticmethod
    def forward(ctx, features, temperature, seed, uniforms, seq_len,
                disc_embed, embed, w_proj, b_proj, *lstm_flat):
        nl = len(lstm_flat) // 4
        layers = _layer_dicts(lstm_flat, nl)
        ids, emb, soft, hs, cs, gates = decode_sample_embed(
            features, layers, w_proj, b_proj, embed, seq_len, disc_embed,
            seed, temperature, uniforms)
        ctx.save_for_backward(features, embed, w_proj, disc_embed, ids,
                              soft, hs, cs, gates, *lstm_flat)
        ctx.temperature, ctx.nl = float(temperature), nl
        ctx.mark_non_differentiable(ids)
        ctx.set_materialize_grads(False)
        return emb, emb.clone(), ids

    @staticmethod
    def backward(ctx, d_gen, d_fake, _d_ids):
        (features, embed, w_proj, disc_embed, ids, soft, hs, cs, gates,
         *lstm_flat) = ctx.saved_tensors
        nl, T, B, V = ctx.nl, *soft.shape
        d_disc = None
        if d_fake is not None:
            d_disc = (d_fake.reshape(T * B, -1).T
                      @ soft.reshape(T * B, V))            # [Ed, V]
        if d_gen is None:
            return (None,) * 5 + (d_disc,) + (None,) * (3 + 4 * nl)
        d_w_proj_t, d_b_proj, d_htop = decode_sample_embed_bwd(
            hs[:, nl - 1].contiguous(), soft, d_gen.contiguous(), w_proj,
            disc_embed, ctx.temperature)
        d_features, d_embed, grads = _bptt_from_dhs(
            features, embed, _layer_dicts(lstm_flat, nl), ids, hs, cs, gates,
            d_htop)
        return (d_features, None, None, None, None, d_disc, d_embed,
                d_w_proj_t.T, d_b_proj, *grads)


def sample_embed(decoder: Decoder, features, seq_len: int, temperature,
                 disc_embed, seed: int = 0, uniforms=None):
    """The adversarial sample already embedded by the discriminator →
    ``(emb_gen [B, T, Ed], emb_fake [B, T, Ed], ids [B, T])``, equal in
    value to ``sample_soft(...)[0] @ disc_embed^T``; ``emb_gen`` carries
    gradient to the decoder and ``features`` only, ``emb_fake`` to
    ``disc_embed [Ed, V]`` only (see :class:`_SampleEmbed`).  Noise as
    :func:`sample_soft`."""
    emb_gen, emb_fake, ids = _SampleEmbed.apply(
        features, float(temperature), int(seed), uniforms, seq_len,
        disc_embed, decoder.embed.weight, decoder.linear.weight,
        decoder.linear.bias, *_decoder_flat(decoder))
    return emb_gen.transpose(0, 1), emb_fake.transpose(0, 1), ids


def rescore(decoder: Decoder, features, ids, plain: bool = False):
    """Differentiable teacher-forced logits ``[B, T, V]`` of a free-running
    decode's ``ids [B, T]``: the input at step t+1 is ``embed[ids[:, t]]``,
    the feedback the decode took.  The ids are integers and carry no
    gradient, but the gathered embedding rows do, as in the JAX package's
    rescore (``_sample_kernel`` / ``_sample_decoupled``) and its
    ``eval/decode.sequence_logprob``: the embedding's gradient sums the
    feedback path's over the rows each id was read from.  The
    ``kernel_rescore`` and ``decoupled`` routes, the free MLE step, the
    REINFORCE log-probs and the SCST update all take that gradient.  The
    backward runs the reverse BPTT kernel unless ``plain``."""
    ids_tm = ids.T.long()
    xs_tm = torch.cat([features[None], decoder.embed.weight[ids_tm[:-1]]])
    hs_tm = lstm.lstm_seq_tm(decoder.lstm.layers(), xs_tm, plain=plain)
    logits_tm = hs_tm @ decoder.linear.weight.T + decoder.linear.bias
    return logits_tm.transpose(0, 1)


def _detached_args(decoder: Decoder, features, seq_len: int):
    return (features.detach(), [{k: v.detach() for k, v in lp.items()}
                                for lp in decoder.lstm.layers()],
            decoder.linear.weight.detach(), decoder.linear.bias.detach(),
            decoder.embed.weight.detach(), seq_len)


def greedy_ids(decoder: Decoder, features, seq_len: int,
               plain: bool = False):
    """Greedy ids ``[B, T]`` int32 of the decode (the serve/greedy kernel on
    CUDA tensors, or the plain version), without gradient."""
    args = _detached_args(decoder, features, seq_len)
    if plain:
        return decode_sample_plain(*args)[0]
    return decode_sample(*args, mode="greedy")


def _soft_of_rescore(decoder: Decoder, features, ids, noise, temperature):
    """``softmax((rescore logits + noise) · temp)`` ``[B, T, V]``, the noise
    ``[T, B, V]`` a constant."""
    logits = rescore(decoder, features, ids)
    return torch.softmax((logits + noise.detach().transpose(0, 1))
                         * temperature, dim=-1)


def sample_kernel_rescore(decoder: Decoder, features, seq_len: int,
                          temperature, seed: int = 0, uniforms=None):
    """The JAX package's ``_sample_kernel`` with ``GIC_KERNEL_VJP=0``
    (``Config(decode_impl="kernel_rescore")``), adversarial: the ids and
    the Gumbel noise from one mode-``sample`` decode, then the
    differentiable rescore of those ids (its backward through the reverse
    BPTT kernel) and ``softmax((logits + noise) · temp)`` →
    ``(soft [B, T, V], ids [B, T])``.  Noise as :func:`sample_soft`."""
    ids, noise = decode_sample_noise(*_detached_args(decoder, features,
                                                     seq_len), seed,
                                     uniforms)
    return _soft_of_rescore(decoder, features, ids, noise, temperature), ids


def _decoupled_ids(decoder: Decoder, features, seq_len: int, noise=None):
    """The gradient-free sampling loop of the JAX package's
    ``_sample_decoupled`` (a ``lax.scan`` there): per step the stacked
    LSTM, the projection, ``argmax(logits [+ noise[t]])`` and the embedding
    feedback, as PyTorch operations → ids ``[B, T]`` int32."""
    with torch.no_grad():
        params = lstm.fuse_layer_params(
            [{k: v.detach() for k, v in lp.items()}
             for lp in decoder.lstm.layers()])
        w, b = decoder.linear.weight.detach(), decoder.linear.bias.detach()
        embed = decoder.embed.weight.detach()
        state = lstm.zero_state(len(params), features.shape[0],
                                w.shape[1], features.dtype, features.device)
        x, ids = features.detach(), []
        for t in range(seq_len):
            h_top, state = lstm.lstm_step(params, x, state)
            logits = h_top @ w.T + b
            if noise is not None:
                logits = logits + noise[t]
            ids_t = torch.argmax(logits, dim=-1)
            ids.append(ids_t)
            x = embed[ids_t]
    return torch.stack(ids, dim=1).to(torch.int32)


def sample_decoupled(decoder: Decoder, features, seq_len: int,
                     pretrain: bool = True, temperature=1.0, seed: int = 0,
                     uniforms=None):
    """``--decode-impl decoupled`` (the JAX package's ``_sample_decoupled``)
    → ``(outputs [B, T, V], ids [B, T] int32)``: the gradient-free sampling
    loop of :func:`_decoupled_ids` on the Gumbel noise of ``uniforms
    [T, B, V]`` (or of uniforms drawn from a generator seeded with
    ``seed``; none when ``pretrain``), then the differentiable rescore of
    the ids, its backward through the reverse BPTT kernel: raw logits
    (``pretrain``) or ``softmax((logits + noise) · temp)`` on the same
    noise."""
    if pretrain:
        ids = _decoupled_ids(decoder, features, seq_len)
        return rescore(decoder, features, ids), ids
    if uniforms is None:
        uniforms = seeded_uniforms(seed, (seq_len, features.shape[0],
                                          decoder.embed.weight.shape[0]),
                                   features.device)
    noise = gumbel_noise(uniforms.shape, u=uniforms)
    ids = _decoupled_ids(decoder, features, seq_len, noise)
    return _soft_of_rescore(decoder, features, ids, noise, temperature), ids


def sample(decoder: Decoder, features, seq_len: int, pretrain: bool = True,
           temperature=1.0, seed: int = 0, uniforms=None,
           route: str = "kernel"):
    """Free-running decode → ``(outputs [B, T, V], ids [B, T] int32)`` on
    the decode route ``route`` (``decode_route(config)``).

    ``pretrain``: greedy ids, then the differentiable teacher-forced
    rescore of those ids — raw logits as outputs (the JAX package's
    ``_sample_kernel``, ``generator.py:470-501``); under ``decoupled`` the
    ids come from :func:`_decoupled_ids`.  With gradients off, the kernel
    routes take ids and logits from one mode-``pretrain`` decode
    (:func:`decode_sample_logits`) instead.  Otherwise the soft Gumbel
    samples: :func:`sample_soft` (``kernel``, ``kernel_embed`` and
    ``plain``), :func:`sample_kernel_rescore` or
    :func:`sample_decoupled`."""
    plain = route == "plain"
    if route == "decoupled":
        return sample_decoupled(decoder, features, seq_len, pretrain,
                                temperature, seed, uniforms)
    if pretrain and not plain and not torch.is_grad_enabled():
        # nothing to differentiate (an eval step, a baseline decode): the
        # mode-pretrain decode's logits, the rescore's values in one call
        ids, logits_tm = decode_sample_logits(*_detached_args(
            decoder, features, seq_len))
        return logits_tm.transpose(0, 1), ids
    if pretrain:
        ids = greedy_ids(decoder, features, seq_len, plain)
        return rescore(decoder, features, ids, plain), ids
    if route == "kernel_rescore":
        return sample_kernel_rescore(decoder, features, seq_len, temperature,
                                     seed, uniforms)
    return sample_soft(decoder, features, seq_len, temperature, seed,
                       uniforms, plain)


def teacher_forced(decoder: Decoder, features, captions,
                   plain: bool = False):
    """Teacher-forced logits ``[B, T+1, V]`` — the reference's
    ``Decoder.forward`` in pretrain mode: the features at t = 0, then the
    embeddings of ``captions [B, T]``.  Its backward runs the reverse BPTT
    kernel unless ``plain``."""
    xs = torch.cat([features[:, None], decoder.embed.weight[captions.long()]],
                   dim=1)
    hs_tm = lstm.lstm_seq_tm(decoder.lstm.layers(), xs.transpose(0, 1),
                             plain=plain)
    logits_tm = hs_tm @ decoder.linear.weight.T + decoder.linear.bias
    return logits_tm.transpose(0, 1)
