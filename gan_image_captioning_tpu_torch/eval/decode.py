"""Caption decoding: greedy, sampled and beam search
(``gan_image_captioning_tpu/eval/decode.py``).

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
  wrapper call as the continuous engine's), or from a transformer's KV
  cache, and stops once every row has emitted ``<E>``.
* The steppers (:func:`make_stepper`) are the per-step plain math of
  each decoder (dense LSTM, int8 / int4 LSTM, transformer over its KV
  cache), for teacher-forced scoring, sampling and beam search.
* A transformer generator decodes greedily through its KV-cache
  ``sample(pretrain=True)`` (JAX ``eval/decode.py:209-222``); its
  logprobs come from the same pass's logits (the teacher-forced logits of
  the greedy ids, which the JAX package recomputes with a second scan).
  The transformer has no serve kernel; its adaptive decode steps its
  stepper (the JAX stepper branch).  A
  conditional transformer's decodes take the encoder's grid as
  ``context`` (the JAX ``ctx_proj`` shape rule; beam searches repeat it
  K times, one copy a beam); its cross-attention keys and values are made
  once a call (``transformer.cross_kv``).
* :func:`sample_decode` (temperature, top-k, top-p, repetition penalty,
  no-repeat n-grams, a minimum length), :func:`beam_search` (GNMT length
  penalty) and :func:`diverse_beam_search` run over a stepper as plain
  PyTorch, as the JAX package runs them outside any Pallas kernel (a
  ``lax.while_loop`` over the per-step cell): beam search reselects its
  rows at every step, so the whole-T decode kernel cannot run it.

:func:`beam_topk` keeps ``lax.top_k``'s order (values descending, ties to
the lower index) with one stable sort; the JAX package's
``GIC_BEAM_TOPK`` picks between two XLA lowerings of that same order and
has no counterpart here.

Early stop.  The JAX package tests ``done.all()`` in its
``while_loop``'s condition on the device.  Here the loop is Python, and
each test is a host read (a device synchronisation), so the searches read
``done`` once every :data:`DONE_READ_EVERY` steps.  The steps run past the
point where every row is done change nothing: a finished beam extends
only with ``<PAD>`` at zero cost (``pad_only``), so the K best
continuations are the beams themselves in their order, and an ended
sample row emits ``<PAD>`` at zero logprob.  The ids and scores are the
JAX package's, and the host waits for the device once per
:data:`DONE_READ_EVERY` steps instead of every step.

Sampling noise.  ``jax.random.categorical(key, x)`` is ``argmax(x +
gumbel(key, x.shape))``; :func:`sample_decode` adds fed Gumbel noise
``[T, B, V]`` (the tests feed the JAX key chain's draws) or draws it from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gan_image_captioning_tpu_torch.config import Config, compute_dtype
from gan_image_captioning_tpu_torch.data.vocab import END, PAD
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_q_serve)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models import lstm as lstm_lib
from gan_image_captioning_tpu_torch.models import transformer as tf_lib
from gan_image_captioning_tpu_torch.models.discriminator import params_of
from gan_image_captioning_tpu_torch.models.generator import greedy_ids
from gan_image_captioning_tpu_torch.ops import quantize as q_lib
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

NEG_INF = -1e9
DONE_READ_EVERY = 4      # steps between two host reads of the done flags


def beam_topk(x, k: int):
    """Top ``k`` along the last axis → ``(values, indices int64)`` in
    ``lax.top_k``'s order: values descending, equal values by ascending
    index (``torch.topk`` promises no order among equal values on CUDA;
    a stable descending sort keeps the lower index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]



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


def transformer_stepper(decoder, config: Config, context=None) -> Stepper:
    """Stepper over a transformer decoder: the state is the KV cache, one
    ``[N, t, heads, head_dim]`` key and value tensor per layer;
    ``context [N, P, C]`` is cross-attended at every step (rows are
    reselected only among copies of one context, so it is not
    gathered)."""
    p = params_of(decoder)
    cross = tf_lib.cross_kv(p, tf_lib.project_context(
        p, context, config.gen_embed_dim), config.gen_num_heads)

    def init_state(n):
        return tf_lib._init_kv_cache(config, n, p["embed"].dtype,
                                     p["embed"].device)

    def step(state, x, t):
        logits, k, v = tf_lib.decode_step(p, config, x, state[0], state[1], t,
                                          cross)
        return logits, (k, v)

    def gather(state, idx):
        return ([k[idx] for k in state[0]], [v[idx] for v in state[1]])

    return Stepper(init_state, step, gather,
                   lambda ids: p["embed"][ids.long()])


def int8_dtype(config: Config):
    """The compute dtype of the quantized decodes (the JAX
    ``_int8_dtype``): bfloat16 under ``--dtype bfloat16``, else float32.
    The stepper and the quantized serve kernel share it."""
    return torch.float32 if config is None else compute_dtype(config)


def quantized_lstm_stepper(qdec: dict, config: Config = None) -> Stepper:
    """Stepper over a quantized decoder: every weight read is the int8
    payload, its scale applied after the product (``qmatmul``).  A packed
    int4 decoder is unpacked once to int8 nibble values.  It computes in
    :func:`int8_dtype` of ``config``: x, the zero state (h and c), the
    products, the biases, the logits and the embedding rows, as the JAX
    stepper does."""
    dtype = int8_dtype(config)
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
        return lstm_lib.zero_state(layers, n, hidden, dtype, device)

    def step(state, x, t):
        h_top, state = q_lib.quantized_lstm_step(qdec, x.to(dtype), state)
        return (q_lib.qmatmul(h_top, qdec["linear"]["w"])
                + qdec["linear"]["b"].to(dtype)), state

    return Stepper(init_state, step, _gather,
                   lambda ids: q_lib.quantized_embed(qdec, ids).to(dtype))


def make_stepper(generator, config: Config = None, context=None) -> Stepper:
    """The stepper of a generator's decoder (``config``: the transformer's
    heads, and the quantized stepper's compute dtype, :func:`int8_dtype`;
    the dense LSTM stepper needs only the weights).  ``context``: the
    conditional transformer's grid; the LSTM takes none."""
    dec = decoder_of(generator)
    if isinstance(dec, tf_lib.TransformerDecoder):
        return transformer_stepper(dec, config, context)
    _lstm_takes_no_context(context)
    if q_lib.is_quantized(dec):
        return quantized_lstm_stepper(dec, config)
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
    lps [B, K], (hT, cT, xT))``.  The kernels carry c in float32; it
    goes in widened and comes back in the carried c's dtype (bfloat16 in
    a bfloat16 quantized decode, as the JAX engines cast it)."""
    if q_lib.is_quantized(dec):
        ids, lps, (hT, cT, xT) = decode_sample_q_serve(
            x, dec, steps, init_state=(h, c.to(torch.float32), x),
            bits=q_lib.payload_bits(dec))
        return ids, lps, (hT, cT.to(c.dtype), xT)
    return decode_sample(x, dec.lstm.layers(), dec.linear.weight,
                         dec.linear.bias, dec.embed.weight, steps,
                         mode="serve", init_state=(h, c, x))


def _quantized_serve(dec, features, seq_len, config: Config):
    """The quantized serve decode in :func:`int8_dtype` (the JAX
    ``features.astype(_int8_dtype(config))``)."""
    return decode_sample_q_serve(features.to(int8_dtype(config)), dec,
                                 seq_len, bits=q_lib.payload_bits(dec))


@torch.no_grad()
def greedy(generator, features, config: Config, seq_len: int = None,
           context=None):
    """Deterministic greedy decode → ids [B, T] int32 (the serve kernels
    on CUDA tensors; a transformer over ``context`` when given)."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    dec = decoder_of(generator)
    if _is_transformer(generator):
        return tf_lib.sample(dec, features, seq_len, True, config,
                             context=context)[1]
    _lstm_takes_no_context(context)
    if q_lib.is_quantized(dec):
        return _quantized_serve(dec, features, seq_len, config)[0]
    return greedy_ids(dec, features, seq_len)


def _lstm_takes_no_context(context):
    if context is not None:
        raise ValueError("a cross-attention context needs a transformer "
                         "generator")


@torch.no_grad()
def greedy_with_logprobs(generator, features, config: Config,
                         seq_len: int = None, context=None):
    """``(ids [B, T] int32, seq_logprob [B])``; ``context``: the
    conditional transformer's grid."""
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    dec = decoder_of(generator)
    if _is_transformer(generator):
        logits, ids = tf_lib.sample(dec, features, seq_len, True, config,
                                    context=context)
        lps = torch.log_softmax(logits, dim=-1).gather(
            2, ids.long()[..., None])[..., 0]
        return ids, masked_logprob_sum(ids, lps)
    _lstm_takes_no_context(context)
    if q_lib.is_quantized(dec):
        ids, lps = _quantized_serve(dec, features, seq_len, config)
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
                                  seq_len: int = None, context=None,
                                  chunk: int = 8):
    """``(ids [B, T] int32, seq_logprob [B])`` with early stopping.

    Same contract as :func:`greedy_with_logprobs` up to and including each
    row's first ``<E>``; the tail after it is ``<PAD>`` (it is outside the
    logprob mask anyway).  The decode runs ``chunk``-step blocks and stops
    once every row has emitted ``<E>``: ``ceil(longest caption / chunk)``
    blocks instead of the full ``seq_len`` steps.  An LSTM block is one
    :func:`decode_chunk` call resuming from the carried ``(h, c, x)``; a
    transformer block is ``chunk`` steps of its stepper at positions ``t
    .. t + chunk - 1`` over the KV cache (``context``: the conditional
    transformer's grid), a row's ids and logprobs voided from the step
    after its first ``<E>``, as the JAX stepper branch does.  The JAX
    package's ``lax.while_loop`` keeps the stop condition on the device;
    here the loop is Python, so every block costs one host read of the
    ``done`` flags (a device synchronisation) before the next is launched.
    """
    seq_len = seq_len or config.seq_len
    api.require_ported(config)
    B, device = features.shape[0], features.device
    K = max(1, min(chunk, seq_len))
    t_pad = -(-seq_len // K) * K
    done = torch.zeros(B, dtype=torch.bool, device=device)
    ids_buf = torch.full((B, t_pad), PAD, dtype=torch.int32, device=device)
    lps_buf = torch.zeros((B, t_pad), dtype=torch.float32, device=device)
    if _is_transformer(generator):
        run_chunk = _transformer_chunks(generator, features, config, context,
                                        seq_len, K)
    else:
        run_chunk = _lstm_chunks(generator, features, config, context, K)
    t = 0
    while t < seq_len:
        ids_k, lps_k, done = run_chunk(t, done)
        ids_buf[:, t:t + ids_k.shape[1]] = ids_k
        lps_buf[:, t:t + ids_k.shape[1]] = lps_k
        t += K
        if bool(done.all()):            # the one host read of this chunk
            break
    return ids_buf[:, :seq_len], lps_buf[:, :seq_len].sum(dim=1)


def _lstm_chunks(generator, features, config, context, K: int):
    """The adaptive decode's LSTM block: one :func:`decode_chunk` call (the
    carried-state serve kernel on CUDA tensors)."""
    _lstm_takes_no_context(context)
    dec = decoder_of(generator)
    h, c = make_stepper(generator, config).init_state(features.shape[0])
    carry = [h, c, features.to(h.dtype)]  # x becomes an embedding row later

    def run_chunk(t, done):
        ids_k, lps_k, carry[:] = decode_chunk(dec, carry[2], carry[0],
                                              carry[1], K)
        is_end = ids_k == END
        # void rows already done and positions after the chunk's first <E>
        after = torch.cumsum(is_end.to(torch.int32), dim=1) - is_end.int()
        void = done[:, None] | (after > 0)
        return (torch.where(void, PAD, ids_k), torch.where(void, 0.0, lps_k),
                done | is_end.any(dim=1))

    return run_chunk


def _transformer_chunks(generator, features, config, context, seq_len: int,
                        K: int):
    """The adaptive decode's transformer block: up to ``K`` stepper steps
    at their positions (the JAX scan's steps past ``seq_len`` are cut from
    its output, so they are not run)."""
    stepper = make_stepper(generator, config, context)
    state = [stepper.init_state(features.shape[0])]
    x = [features.to(stepper.embed(torch.zeros(
        1, dtype=torch.long, device=features.device)).dtype)]

    def run_chunk(t, done):
        ids, lps = [], []
        for pos in range(t, min(t + K, seq_len)):
            logits, state[0] = stepper.step(state[0], x[0], pos)
            raw = torch.argmax(logits, dim=-1)
            lp = torch.log_softmax(logits, dim=-1).gather(
                1, raw[:, None])[:, 0].to(torch.float32)
            ids.append(torch.where(done, PAD, raw.to(torch.int32)))
            lps.append(torch.where(done, 0.0, lp))
            done = done | (raw == END)
            x[0] = stepper.embed(raw)
        return torch.stack(ids, dim=1), torch.stack(lps, dim=1), done

    return run_chunk


@torch.no_grad()
def sequence_logprob(generator, features, ids, config: Config,
                     context=None):
    """Greedy-path log-probability of given token sequences under the
    model, teacher-forcing the ids; positions after the first ``<E>`` do
    not count."""
    api.require_ported(config)
    stepper = make_stepper(generator, config, context)
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


# ------------------------------------------------------------------ sampling

def _scalar(value, like):
    """``value`` as a one-element float32 tensor on ``like``'s device: a
    division by it is a true division on every device (CUDA divides by a
    host scalar as a product with its reciprocal)."""
    return torch.full((1,), value, dtype=like.dtype, device=like.device)


def filter_logits(logits, temperature=1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature + top-k + nucleus (top-p) filtering of ``[N, V]``
    logits (the GPT-2 recipe): scale by the temperature, keep the k
    highest logits, then the smallest prefix of the sorted distribution
    whose mass reaches ``top_p`` (the top token is always kept).  Filtered
    entries drop to :data:`NEG_INF`."""
    logits = logits / torch.clamp(_scalar(temperature, logits), min=1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]      # [N, 1]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p                 # >= 1 kept a row
        last_kept = keep_sorted.sum(dim=-1) - 1                       # [N]
        thresh = sorted_logits.gather(1, last_kept[:, None])          # [N, 1]
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def _ngram_ban(ids_buf, t: int, last_ids, n: int, V: int):
    """``[B, V]`` bool mask of the tokens that would complete, at position
    ``t``, an n-gram already in ``ids_buf[:, :t]`` (no-repeat-ngram): for
    every history position j whose n-1 tokens before it match the current
    suffix, ``ids_buf[:, j]`` is banned.  One ``scatter_`` into a
    ``[B, V+1]`` mask, column V taking the positions that ban nothing."""
    B, T = ids_buf.shape
    pos = torch.arange(T, device=ids_buf.device)
    prev1 = torch.nn.functional.pad(ids_buf, (1, 0))[:, :T]  # token at j-1
    match = prev1 == last_ids[:, None]
    if n == 3:
        prev2 = torch.nn.functional.pad(ids_buf, (2, 0))[:, :T]  # at j-2
        two_back = ids_buf[:, max(t - 2, 0)]
        match &= (prev2 == two_back[:, None]) & (pos >= 2)[None]
    else:
        match &= (pos >= 1)[None]
    match &= (pos < t)[None]                                 # history only
    banned_tok = torch.where(match, ids_buf, V).long()
    mask = torch.zeros((B, V + 1), dtype=torch.bool, device=ids_buf.device)
    return mask.scatter_(1, banned_tok, True)[:, :V]


@torch.no_grad()
def sample_decode(generator, features, config: Config, rng=None,
                  seq_len: int = None, context=None, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  early_stop: bool = False, repetition_penalty: float = 1.0,
                  no_repeat_ngram: int = 0, min_length: int = 0,
                  noise=None):
    """Stochastic decode → ``(ids [B, T] int32, seq_logprob [B])``: each
    token drawn from the temperature / top-k / top-p filtered categorical
    (``argmax(filtered + Gumbel noise)``).  The noise is ``noise[t]`` of
    the fed ``[T, B, V]`` tensor, or drawn per step from the
    ``torch.Generator`` ``rng`` on the features' device.

    Reported log-probabilities are under the model's unfiltered
    distribution, masked after the first ``<E>``.  ``top_k=1`` is greedy.
    ``early_stop``: ended rows emit ``<PAD>`` at zero logprob and the loop
    ends once every row has sampled ``<E>`` (read every
    :data:`DONE_READ_EVERY` steps; the module docstring says why that is
    the same result).  Selection-only controls, as in the JAX package:
    ``repetition_penalty`` γ (logits of emitted tokens divided by γ, or
    multiplied when negative), ``no_repeat_ngram`` n ∈ {2, 3} and
    ``min_length`` (``<E>`` banned before it)."""
    seq_len = seq_len or config.seq_len
    if no_repeat_ngram not in (0, 2, 3):
        raise ValueError("no_repeat_ngram must be 0, 2 or 3")
    B, V, device = features.shape[0], config.vocab_size, features.device
    stepper = make_stepper(generator, config, context)
    state = stepper.init_state(B)
    rep_pen = _scalar(repetition_penalty, features)
    track_seen = repetition_penalty != 1.0

    def pick(t, logits, seen, banned):
        sel = logits
        if seen is not None:
            pen = torch.where(logits > 0, logits / rep_pen, logits * rep_pen)
            sel = torch.where(seen, pen, logits)
        if banned is not None:
            sel = torch.where(banned, NEG_INF, sel)
        if t < min_length:
            sel = sel.clone()
            sel[:, END] = NEG_INF
        filt = filter_logits(sel, temperature, top_k, top_p)
        g = noise[t] if noise is not None else gumbel_noise(
            filt.shape, rng, device)
        ids_t = torch.argmax(g + filt, dim=-1)
        lp = torch.log_softmax(logits, dim=-1).gather(1, ids_t[:, None])[:, 0]
        return ids_t, lp

    logits0, state = stepper.step(state, features, 0)
    ids0, lp0 = pick(0, logits0, None, None)
    ids_buf = torch.zeros((B, seq_len), dtype=torch.int32, device=device)
    lps_buf = torch.zeros((B, seq_len), dtype=torch.float32, device=device)
    ids_buf[:, 0] = ids0
    lps_buf[:, 0] = lp0
    seen = None
    if track_seen:
        seen = torch.zeros((B, V), dtype=torch.bool, device=device)
        seen.scatter_(1, ids0[:, None], True)
    done = ids0 == END
    last_ids = ids0
    for t in range(1, seq_len):
        if early_stop and (t - 1) % DONE_READ_EVERY == 0 and bool(done.all()):
            break
        logits, state = stepper.step(state, stepper.embed(last_ids), t)
        banned = (None if not no_repeat_ngram else
                  _ngram_ban(ids_buf, t, last_ids.to(torch.int32),
                             no_repeat_ngram, V))
        ids_t, lp = pick(t, logits, seen, banned)
        if track_seen:
            seen.scatter_(1, ids_t[:, None], True)
        out_ids, out_lp = ids_t, lp
        if early_stop:
            # live rows draw what the full run draws (noise[t] is
            # positional); ended rows' draws are discarded
            out_ids = torch.where(done, PAD, ids_t)
            out_lp = torch.where(done, 0.0, lp)
        done = done | (ids_t == END)
        ids_buf[:, t] = out_ids
        lps_buf[:, t] = out_lp
        last_ids = ids_t
    return ids_buf, masked_logprob_sum(ids_buf, lps_buf)


# --------------------------------------------------------------- beam search

def _pad_only(V: int, like):
    """The continuation log-probs of a finished beam: ``<PAD>`` at zero
    cost, everything else :data:`NEG_INF`."""
    pad_only = torch.full((V,), NEG_INF, dtype=like.dtype, device=like.device)
    pad_only[PAD] = 0.0
    return pad_only


def _ban_end(logp, t: int, min_length: int):
    """``<E>`` at :data:`NEG_INF` before ``min_length`` tokens stand
    (selection only)."""
    if t < min_length:
        logp = logp.clone()
        logp[..., END] = NEG_INF
    return logp


def _reselect(stepper, new_state, tokens, lengths, done, parent, token,
              t: int):
    """The beams' state, token buffer, lengths and done flags after each
    beam ``k`` of row ``b`` took ``token[b, k]`` after beam
    ``parent[b, k]``."""
    B, K = parent.shape
    gidx = (torch.arange(B, device=parent.device)[:, None] * K
            + parent).reshape(-1)
    state = stepper.gather(new_state, gidx)
    tokens = tokens.gather(1, parent[..., None].expand(-1, -1,
                                                        tokens.shape[2]))
    tokens[:, :, t] = token.to(torch.int32)
    parent_done = done.gather(1, parent)
    parent_len = lengths.gather(1, parent)
    done = parent_done | (token == END)
    lengths = torch.where(parent_done, parent_len, parent_len + 1)
    return state, tokens, lengths, done


def _repeat(context, k: int):
    return None if context is None else context.repeat_interleave(k, 0)


def _length_normalized(scores, lengths, length_penalty: float):
    """GNMT: ``scores / ((5 + length) / 6) ** length_penalty``."""
    return scores / ((5.0 + lengths.to(torch.float32)) / 6.0) ** length_penalty


@torch.no_grad()
def beam_search(generator, features, config: Config, beam_size: int = 4,
                seq_len: int = None, context=None,
                length_penalty: float = 0.0, early_stop: bool = True,
                min_length: int = 0):
    """Batched beam search → ``(ids [B, T] int32, scores [B])``.

    All ``B·K`` hypotheses advance through the stepper one step at a time;
    each row keeps the top K of its ``K·V`` continuations
    (:func:`beam_topk`: parent ``flat // V``, token ``flat % V``) and the
    stepper's ``gather`` reindexes the carried state (the LSTM's
    ``(h, c)``, the transformer's per-layer KV lists).  A beam that has
    emitted ``<E>`` extends only with ``<PAD>`` at zero cost
    (``pad_only``), so ``early_stop`` (the loop ends once every beam of
    every row is done) gives the full-T result.  The best beam by the
    GNMT length penalty ``((5 + len) / 6) ** length_penalty`` is returned
    with its normalized score.  ``context`` is repeated K times, one copy
    a beam (JAX ``jnp.repeat(context, K, axis=0)``)."""
    seq_len = seq_len or config.seq_len
    K, B, V = beam_size, features.shape[0], config.vocab_size
    device = features.device
    stepper = make_stepper(generator, config, _repeat(context, K))

    # t = 0: every beam of a row reads the features; the row's top K
    state = stepper.init_state(B * K)
    logits0, state = stepper.step(state, features.repeat_interleave(K, 0), 0)
    logp0 = _ban_end(torch.log_softmax(logits0.reshape(B, K, V)[:, 0], -1),
                     0, min_length)
    scores, ids0 = beam_topk(logp0, K)                          # [B, K]
    done = ids0 == END
    tokens = torch.full((B, K, seq_len), PAD, dtype=torch.int32,
                        device=device)
    tokens[:, :, 0] = ids0.to(torch.int32)
    lengths = torch.ones((B, K), dtype=torch.int32, device=device)
    pad_only = _pad_only(V, logits0)
    last = ids0
    for t in range(1, seq_len):
        if early_stop and (t - 1) % DONE_READ_EVERY == 0 and bool(done.all()):
            break
        logits, new_state = stepper.step(state, stepper.embed(
            last.reshape(-1)), t)
        logp = _ban_end(torch.log_softmax(logits, -1).reshape(B, K, V), t,
                        min_length)
        logp = torch.where(done[..., None], pad_only, logp)
        scores, flat_idx = beam_topk((scores[..., None] + logp).reshape(
            B, K * V), K)
        parent, last = flat_idx // V, flat_idx % V
        state, tokens, lengths, done = _reselect(
            stepper, new_state, tokens, lengths, done, parent, last, t)

    final = _length_normalized(scores, lengths, length_penalty)
    best = torch.argmax(final, dim=1)                               # [B]
    rows = torch.arange(B, device=device)
    return tokens[rows, best], final[rows, best]


@torch.no_grad()
def diverse_beam_search(generator, features, config: Config,
                        beam_size: int = 4, num_groups: int = 2,
                        diversity_strength: float = 0.5,
                        seq_len: int = None, context=None,
                        length_penalty: float = 0.0, min_length: int = 0):
    """Diverse beam search (Vijayakumar et al. 2016) → ``(ids [B, G, T]
    int32, scores [B, G])``, one caption per group.

    ``beam_size`` beams in ``num_groups`` groups of ``beam_size / G``; at
    every step the groups select in turn, group g's candidate log-probs
    lowered by ``diversity_strength`` times the number of times each token
    was chosen at this step by the groups before it (Hamming diversity,
    ``<PAD>`` not counted).  Each group's best beam is ranked by the
    penalized objective, but its reported score is the true length-
    normalized log-probability.  ``G = 1``, ``diversity_strength = 0`` is
    vanilla beam search.  The loop ends once every beam is done (read
    every :data:`DONE_READ_EVERY` steps; ``context`` repeated K times, as
    in :func:`beam_search`)."""
    seq_len = seq_len or config.seq_len
    K, G = beam_size, num_groups
    if K % G:
        raise ValueError(f"beam_size {K} must divide into num_groups {G}")
    Kg = K // G
    B, V, device = features.shape[0], config.vocab_size, features.device
    lam = torch.tensor(diversity_strength, dtype=torch.float32, device=device)
    stepper = make_stepper(generator, config, _repeat(context, K))

    def select(logp, scores, t0: bool):
        """Group-sequential top-Kg → (penalized scores, parent beam,
        token, the token's true step log-prob)."""
        counts = torch.zeros((B, V), dtype=torch.float32, device=device)
        out_s, out_p, out_tok = [], [], []
        for g in range(G):
            lp_g = logp[:, g * Kg:(g + 1) * Kg] - lam * counts[:, None, :]
            if t0:                       # every beam of a group is alike
                s_g, tok_g = beam_topk(lp_g[:, 0], Kg)
                par_g = torch.full_like(tok_g, g * Kg)
            else:
                cand = scores[:, g * Kg:(g + 1) * Kg, None] + lp_g
                s_g, flat = beam_topk(cand.reshape(B, Kg * V), Kg)
                par_g, tok_g = flat // V + g * Kg, flat % V
            live_tok = torch.where(tok_g == PAD, V, tok_g)   # V: off-table
            hits = torch.zeros((B, V + 1), dtype=torch.float32, device=device)
            hits.scatter_add_(1, live_tok, torch.ones_like(s_g))
            counts = counts + hits[:, :V]
            out_s.append(s_g)
            out_p.append(par_g)
            out_tok.append(tok_g)
        parent, token = torch.cat(out_p, dim=1), torch.cat(out_tok, dim=1)
        step_lp = logp.gather(1, parent[..., None].expand(-1, -1, V)).gather(
            2, token[..., None])[..., 0]
        return torch.cat(out_s, dim=1), parent, token, step_lp

    state = stepper.init_state(B * K)
    logits0, state = stepper.step(state, features.repeat_interleave(K, 0), 0)
    logp0 = _ban_end(torch.log_softmax(logits0, -1).reshape(B, K, V), 0,
                     min_length)
    scores, _, last, true_scores = select(logp0, None, t0=True)
    done = last == END
    tokens = torch.full((B, K, seq_len), PAD, dtype=torch.int32,
                        device=device)
    tokens[:, :, 0] = last.to(torch.int32)
    lengths = torch.ones((B, K), dtype=torch.int32, device=device)
    pad_only = _pad_only(V, logits0)
    for t in range(1, seq_len):
        if (t - 1) % DONE_READ_EVERY == 0 and bool(done.all()):
            break
        logits, new_state = stepper.step(state, stepper.embed(
            last.reshape(-1)), t)
        logp = _ban_end(torch.log_softmax(logits, -1).reshape(B, K, V), t,
                        min_length)
        logp = torch.where(done[..., None], pad_only, logp)
        scores, parent, last, step_lp = select(logp, scores, t0=False)
        true_scores = true_scores.gather(1, parent) + step_lp
        state, tokens, lengths, done = _reselect(
            stepper, new_state, tokens, lengths, done, parent, last, t)

    final = _length_normalized(scores, lengths, length_penalty).reshape(
        B, G, Kg)
    true_final = _length_normalized(true_scores, lengths,
                                    length_penalty).reshape(B, G, Kg)
    best = torch.argmax(final, dim=2)                                # [B, G]
    best_tokens = tokens.reshape(B, G, Kg, seq_len).gather(
        2, best[:, :, None, None].expand(-1, -1, 1, seq_len))[:, :, 0]
    return best_tokens, true_final.gather(2, best[..., None])[..., 0]
