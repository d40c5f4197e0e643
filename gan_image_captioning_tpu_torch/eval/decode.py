"""Greedy caption decoding (``gan_image_captioning_tpu/eval/decode.py``).

A generator here is a port :class:`Generator` or the quantized twin
``{"decoder": qdec}`` of ``ops/quantize.py:quantize_generator``.

* :func:`greedy_with_logprobs` is the serving decode.  On CUDA tensors it
  is one call of a serve-mode decode kernel (greedy ids and per-token
  logprobs together): the dense one, or the quantized one for a quantized
  decoder.  On the CPU a dense decoder takes the plain composition
  :func:`greedy` + :func:`sequence_logprob`, as the JAX package does off
  the TPU, and a quantized one the quantized kernel's plain version.
* :func:`greedy_with_logprobs_adaptive` decodes in K-step chunks that
  resume from the carried ``(h, c, x)`` (:func:`decode_chunk`, the same
  wrapper call as the continuous engine's) and stops once every row has
  emitted ``<E>``.
* The steppers (:func:`make_stepper`) are the per-step plain math of
  each decoder, for teacher-forced scoring.
* A transformer generator decodes greedily through its KV-cache
  ``sample(pretrain=True)`` (JAX ``eval/decode.py:209-222``); its
  logprobs come from the same pass's logits (the teacher-forced logits of
  the greedy ids, which the JAX package recomputes with a second scan).
  The transformer has no serve kernel and no adaptive decode here.

Beam search and sampling are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.vocab import END, PAD
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_q_serve)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
from gan_image_captioning_tpu_torch.models import transformer as tf_lib
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.models.generator import greedy_ids
from gan_image_captioning_tpu_torch.ops import quantize as q_lib


class Stepper(NamedTuple):
    init_state: Callable[[int], Any]           # n → state
    step: Callable[[Any, Any, Any], Any]       # (state, x [N, E], t) → (logits, state)
    gather: Callable[[Any, Any], Any]          # (state, idx [N]) → state
    embed: Callable[[Any], Any]                # ids [N] → [N, E]


def decoder_of(generator):
    """The decoder of a :class:`Generator` or of a quantized twin."""
    return generator["decoder"] if isinstance(generator, dict) \
        else generator.decoder


def _gather(state, idx):
    h, c = state
    return h[:, idx], c[:, idx]        # the row axis is 1 of [L, N, H]


def lstm_stepper(decoder) -> Stepper:
    """Stepper over a dense port ``Decoder``."""
    layers = decoder.lstm.layers()
    fused = lstm_lib.fuse_layer_params(layers)
    hidden = layers[0]["w_hh"].shape[1]
    weight = decoder.embed.weight

    def init_state(n):
        return lstm_lib.zero_state(len(layers), n, hidden, weight.dtype,
                                   weight.device)

    def step(state, x, t):
        h_top, state = lstm_lib.lstm_step(fused, x, state)
        return h_top @ decoder.linear.weight.T + decoder.linear.bias, state

    return Stepper(init_state, step, _gather, lambda ids: weight[ids.long()])


def transformer_stepper(decoder, config: Config) -> Stepper:
    """Stepper over a transformer decoder: the state is the KV cache, one
    ``[N, t, heads, head_dim]`` key and value tensor per layer."""
    p = params_of(decoder)

    def init_state(n):
        return tf_lib._init_kv_cache(config, n, p["embed"].dtype,
                                     p["embed"].device)

    def step(state, x, t):
        logits, k, v = tf_lib.decode_step(p, config, x, state[0], state[1], t)
        return logits, (k, v)

    def gather(state, idx):
        return ([k[idx] for k in state[0]], [v[idx] for v in state[1]])

    return Stepper(init_state, step, gather,
                   lambda ids: p["embed"][ids.long()])


def quantized_lstm_stepper(qdec: dict) -> Stepper:
    """Stepper over a quantized decoder: every weight read is the int8
    payload, its scale applied after the product (``qmatmul``).  A packed
    int4 decoder is unpacked once to int8 nibble values."""
    if q_lib.payload_bits(qdec) == 4:
        unpack = q_lib.unpack_int4_rows
        qdec = dict(
            qdec,
            lstm_q=[{"w": q_lib.QTensor(unpack(lq["w"].q), lq["w"].scale),
                     "b": lq["b"]} for lq in qdec["lstm_q"]],
            linear={"w": q_lib.QTensor(unpack(qdec["linear"]["w"].q),
                                       qdec["linear"]["w"].scale),
                    "b": qdec["linear"]["b"]},
            embed=q_lib.QTensor(unpack(qdec["embed"].q),
                                qdec["embed"].scale))
    layers = len(qdec["lstm_q"])
    hidden = qdec["lstm_q"][0]["w"].q.shape[1] // 4
    device = qdec["linear"]["b"].device

    def init_state(n):
        return lstm_lib.zero_state(layers, n, hidden, torch.float32, device)

    def step(state, x, t):
        h_top, state = q_lib.quantized_lstm_step(qdec, x.to(torch.float32),
                                                 state)
        return (q_lib.qmatmul(h_top, qdec["linear"]["w"])
                + qdec["linear"]["b"]), state

    return Stepper(init_state, step, _gather,
                   lambda ids: q_lib.quantized_embed(qdec, ids))


def make_stepper(generator, config: Config = None) -> Stepper:
    """The stepper of a generator's decoder (``config``: the transformer's
    heads; both LSTM steppers need only the weights)."""
    dec = decoder_of(generator)
    if q_lib.is_quantized(dec):
        return quantized_lstm_stepper(dec)
    if isinstance(dec, tf_lib.TransformerDecoder):
        return transformer_stepper(dec, config)
    return lstm_stepper(dec)


def _is_transformer(generator) -> bool:
    return isinstance(decoder_of(generator), tf_lib.TransformerDecoder)


def _stepper_greedy(stepper: Stepper, features, seq_len: int):
    """Greedy argmax decode through a Stepper → ids [B, T] int32."""
    state = stepper.init_state(features.shape[0])
    x, ids = features, []
    for t in range(seq_len):
        logits, state = stepper.step(state, x, t)
        ids_t = torch.argmax(logits, dim=-1)
        ids.append(ids_t)
        x = stepper.embed(ids_t)
    return torch.stack(ids, dim=1).to(torch.int32)


def kernel_serve_available(features) -> bool:
    """The serve-mode decode kernels run where the tensors are: on a CUDA
    device."""
    return features.is_cuda


def kernel_quantized_available(dec) -> bool:
    """The quantized serve kernel reads int8 payloads (int8, or the
    row-packed int4 carrier): true for a quantized decoder whose every
    payload is int8."""
    if not q_lib.is_quantized(dec):
        return False
    payloads = [lq["w"].q for lq in dec["lstm_q"]]
    payloads += [dec["linear"]["w"].q, dec["embed"].q]
    return all(q.dtype == torch.int8 for q in payloads)


def masked_logprob_sum(ids, lps):
    """Per-sequence greedy log-probability: sum per-token logprobs up to
    and including the FIRST ``<E>`` (``sequence_logprob``'s masking)."""
    is_end = ids == END
    ncum = torch.cumsum(is_end.to(torch.int32), dim=1)
    keep = (ncum == 0) | (is_end & (ncum == 1))
    return torch.where(keep, lps, torch.zeros_like(lps)).sum(dim=1)


def decode_chunk(dec, x, h, c, steps: int):
    """``steps`` serve-mode decode steps from the carried ``(h, c, x)``:
    one call of the dense or the quantized serve wrapper (the kernel on
    CUDA tensors, its plain version on CPU ones) → ``(ids [B, K],
    lps [B, K], (hT, cT, xT))``."""
    if q_lib.is_quantized(dec):
        return decode_sample_q_serve(x, dec, steps, init_state=(h, c, x),
                                     bits=q_lib.payload_bits(dec))
    return decode_sample(x, dec.lstm.layers(), dec.linear.weight,
                         dec.linear.bias, dec.embed.weight, steps,
                         mode="serve", init_state=(h, c, x))


def _quantized_serve(dec, features, seq_len):
    return decode_sample_q_serve(features, dec, seq_len,
                                 bits=q_lib.payload_bits(dec))


@torch.no_grad()
def greedy(generator, features, config: Config, seq_len: int = None):
    """Deterministic greedy decode → ids [B, T] int32 (the serve kernels
    on CUDA tensors)."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    dec = decoder_of(generator)
    if q_lib.is_quantized(dec):
        return _quantized_serve(dec, features, seq_len)[0]
    if _is_transformer(generator):
        return tf_lib.sample(dec, features, seq_len, True, config)[1]
    return greedy_ids(dec, features, seq_len)


@torch.no_grad()
def greedy_with_logprobs(generator, features, config: Config,
                         seq_len: int = None):
    """``(ids [B, T] int32, seq_logprob [B])``."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    dec = decoder_of(generator)
    if q_lib.is_quantized(dec):
        ids, lps = _quantized_serve(dec, features, seq_len)
        return ids, masked_logprob_sum(ids, lps)
    if _is_transformer(generator):
        logits, ids = tf_lib.sample(dec, features, seq_len, True, config)
        lps = torch.log_softmax(logits, dim=-1).gather(
            2, ids.long()[..., None])[..., 0]
        return ids, masked_logprob_sum(ids, lps)
    if kernel_serve_available(features):
        ids, lps = decode_sample(features, dec.lstm.layers(),
                                 dec.linear.weight, dec.linear.bias,
                                 dec.embed.weight, seq_len, mode="serve")
        return ids, masked_logprob_sum(ids, lps)
    ids = greedy(generator, features, config, seq_len)
    return ids, sequence_logprob(generator, features, ids, config)


@torch.no_grad()
def greedy_with_logprobs_adaptive(generator, features, config: Config,
                                  seq_len: int = None, chunk: int = 8):
    """``(ids [B, T] int32, seq_logprob [B])`` with early stopping.

    Same contract as :func:`greedy_with_logprobs` up to and including each
    row's first ``<E>``; the tail after it is ``<PAD>`` (it is outside the
    logprob mask anyway).  The decode runs ``chunk``-step blocks, each one
    :func:`decode_chunk` call resuming from the carried ``(h, c, x)``, and
    stops once every row has emitted ``<E>``: ``ceil(longest caption /
    chunk)`` blocks instead of the full ``seq_len`` steps.  The JAX
    package's ``lax.while_loop`` keeps that condition on the device; here
    the loop is Python, so every chunk costs one host read of the ``done``
    flags (a device synchronisation) before the next is launched.
    """
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    if _is_transformer(generator):
        raise NotImplementedError("the adaptive (early-stopping) decode of a "
                                  "transformer generator is not ported yet")
    dec = decoder_of(generator)
    B, device = features.shape[0], features.device
    K = max(1, min(chunk, seq_len))
    t_pad = -(-seq_len // K) * K
    stepper = make_stepper(generator, config)
    h, c = stepper.init_state(B)
    x = features
    done = torch.zeros(B, dtype=torch.bool, device=device)
    ids_buf = torch.full((B, t_pad), PAD, dtype=torch.int32, device=device)
    lps_buf = torch.zeros((B, t_pad), dtype=torch.float32, device=device)
    t = 0
    while t < seq_len:
        ids_k, lps_k, (h, c, x) = decode_chunk(dec, x, h, c, K)
        is_end = ids_k == END
        # void rows already done and positions after the chunk's first <E>
        after = torch.cumsum(is_end.to(torch.int32), dim=1) - is_end.int()
        void = done[:, None] | (after > 0)
        ids_buf[:, t:t + K] = torch.where(void, PAD, ids_k)
        lps_buf[:, t:t + K] = torch.where(void, 0.0, lps_k)
        done = done | is_end.any(dim=1)
        t += K
        if bool(done.all()):            # the one host read of this chunk
            break
    return ids_buf[:, :seq_len], lps_buf[:, :seq_len].sum(dim=1)


@torch.no_grad()
def sequence_logprob(generator, features, ids, config: Config):
    """Greedy-path log-probability of given token sequences under the
    model, teacher-forcing the ids; positions after the first ``<E>`` do
    not count."""
    api.require_ported(config)
    stepper = make_stepper(generator, config)
    T = ids.shape[1]
    state = stepper.init_state(ids.shape[0])
    ids_l = ids.to(torch.long)
    x = features
    lps = []
    for t in range(T):
        logits, state = stepper.step(state, x, t)
        logp = torch.log_softmax(logits, dim=-1)
        lps.append(logp.gather(1, ids_l[:, t:t + 1])[:, 0])
        x = stepper.embed(ids_l[:, t])
    return masked_logprob_sum(ids, torch.stack(lps, dim=1))
