"""``--dtype bfloat16`` in the port's decodes against the JAX package's, on
the CPU (the port's plain versions; the JAX Pallas kernels in interpret
mode), from the same weights and feature rows (numpy, from a seed):

* the quantized serve decode computes in ``config.dtype`` (the JAX
  ``_int8_dtype``): ``greedy_with_logprobs`` of an int8 and an int4
  decoder at ``dtype="bfloat16"``, the quantized stepper, and the
  continuous engine's chunks;
* the decode kernel's bfloat16 instantiation, plain version: modes
  ``sample_resid`` (soft sample and residuals in bfloat16), ``greedy``,
  ``pretrain`` (bfloat16 logits) and the quantized serve.

The JAX generator's weights are scaled by ``PEAK = 8`` (as the beam
tests do), so that a step's logits are spread and a float32 decode parts
clearly from a bfloat16 one.

Ids: equal, or equally scored — where the two sides first pick different
ids in a row, their log-probabilities (or scores) at that step agree
within the tolerance (a bfloat16 tie), and the row is not compared past
it.  Tolerances are numbers of bfloat16 units, a unit being 2^-8 of the
largest entry compared (the most one rounding to bfloat16 moves a value
of that size).  Both sides round h, x and the weights at the same places,
so they part only where a float32 sum taken in another order tips one
rounding: float32 results (log-probabilities, scores) are held to 1 unit,
bfloat16 outputs (the soft sample, the residuals, the logits) to 2 units,
one bfloat16 step of the largest entry.  Decoding the same weights in
float32 misses the JAX package's bfloat16 log-probabilities by 6-20
units at these shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.eval import decode as jdecode
from gan_image_captioning_tpu.kernels.decode_sample import (
    decode_sample as jdecode_sample, decode_sample_q_serve as jq_serve)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.interop import (generator_from_jax,
                                                    qdec_from_jax)
from gan_image_captioning_tpu_torch.kernels import decode_sample as tks

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

B, T, V, H, E = 4, 8, 256, 32, 32
UNIT = 2.0 ** -8           # one bfloat16 rounding, relative
F32_UNITS, BF16_UNITS, STEPPER_UNITS = 1, 2, 4
PEAK = 8.0
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


def _configs(dtype="bfloat16"):
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=2, max_seq_len=T - 2, dtype=dtype)
    return JConfig(**kw), Config(**kw)


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tol(ref, units=F32_UNITS):
    return units * UNIT * float(np.max(np.abs(np.asarray(ref, np.float32))))


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _decoders(seed=3):
    jconfig, config = _configs("float32")
    jdec = jax.tree_util.tree_map(
        lambda a: a * PEAK,
        jgen.init_decoder_params(jax.random.PRNGKey(seed), jconfig))
    tree = jax.tree_util.tree_map(np.asarray, {"decoder": jdec})
    return jdec, generator_from_jax(tree, config).requires_grad_(False)


def _quantized(jdec, bits):
    jqdec = jq.quantize_lstm_decoder(jdec, bits=bits, pack_int4=bits == 4)
    return jqdec, qdec_from_jax(jax.tree_util.tree_map(np.asarray, jqdec))


def assert_ids_agree(ids, ids_ref, score, score_ref, tol):
    """``ids [B, T]`` equal to ``ids_ref``, or equally scored: per row up
    to the first differing step, ``score [B, T]`` (the chosen id's
    log-probability or score) within ``tol`` of ``score_ref``; at that
    step too, and nothing past it.  Returns the number of rows that
    parted at a tie."""
    ids, ids_ref = np.asarray(ids), np.asarray(ids_ref)
    score, score_ref = np.asarray(score), np.asarray(score_ref)
    parted = 0
    for b in range(ids.shape[0]):
        diff = np.flatnonzero(ids[b] != ids_ref[b])
        stop = diff[0] + 1 if diff.size else ids.shape[1]
        parted += bool(diff.size)
        np.testing.assert_allclose(score[b, :stop], score_ref[b, :stop],
                                   atol=tol, rtol=0,
                                   err_msg=f"row {b} (parted at {stop - 1})")
    return parted


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  tree)


def _bf16_layers(gen):
    dec = gen.decoder
    return ([{k: v.to(BF) for k, v in lp.items()} for lp in dec.lstm.layers()],
            dec.linear.weight.to(BF), dec.linear.bias.to(BF),
            dec.embed.weight.to(BF))


# ------------------------------------------- the quantized decode's dtype

@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_greedy_follows_dtype_bfloat16(bits):
    """The fault this slice repairs: the port's quantized greedy decode
    computed in float32 under ``--dtype bfloat16``; the JAX package's
    computes in bfloat16 (``features.astype(_int8_dtype(config))``): the
    sequence log-probabilities differ by far more than the tolerance."""
    jconfig, config = _configs()
    jdec, _ = _decoders(seed=7)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(21, (B, E))
    ids_j, lp_j = jdecode.greedy_with_logprobs(
        {"decoder": jqdec}, jnp.asarray(feats), jconfig)
    ids, lp = tdecode.greedy_with_logprobs({"decoder": qdec},
                                           torch.from_numpy(feats), config)
    ids_j, lp_j = np.asarray(ids_j), np.asarray(lp_j)
    assert len(np.unique(ids_j)) > 2
    # per-token log-probabilities of the same decodes, for the ties
    _, lps_j = jq_serve(jnp.asarray(feats, jnp.bfloat16), jqdec, T - 2,
                        bits=bits)
    _, lps = tks.decode_sample_q_serve(torch.from_numpy(feats).to(BF), qdec,
                                       T - 2, bits=bits)
    assert_ids_agree(ids.numpy(), ids_j, lps.numpy(), np.asarray(lps_j),
                     _tol(lps_j))
    same = (ids.numpy() == ids_j).all(axis=1)
    assert same.sum() >= B - 1
    np.testing.assert_allclose(lp.numpy()[same], lp_j[same], rtol=0,
                               atol=_tol(lps_j))


@pytest.mark.parametrize("bits", [8, 4])
def test_q_serve_bfloat16_plain_matches_jax(bits):
    """The quantized serve kernel's bfloat16 instantiation (plain version)
    against ``_qserve_kernel`` on bfloat16 features: dequantized weights,
    h and x in bfloat16, c and the log-probabilities float32."""
    jdec, _ = _decoders(seed=9)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(22, (B, E))
    ids_j, lps_j = jq_serve(jnp.asarray(feats, jnp.bfloat16), jqdec, T,
                            bits=bits)
    ids, lps = tks.decode_sample_q_serve(torch.from_numpy(feats).to(BF),
                                         qdec, T, bits=bits)
    assert lps.dtype == torch.float32
    assert_ids_agree(ids.numpy(), np.asarray(ids_j), lps.numpy(),
                     np.asarray(lps_j), _tol(lps_j))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_stepper_computes_in_dtype(bits):
    """The quantized stepper (beam search, sampling, the adaptive decode)
    against the JAX ``quantized_lstm_stepper`` at ``dtype="bfloat16"``:
    its state and logits are bfloat16; three steps' logits within
    ``STEPPER_UNITS``.  Every operation of this stepper is a bfloat16
    operation: PyTorch rounds the result of each, XLA may round once per
    fused chain, so a layer's cell update (four operations) can part by
    up to four roundings of c and h, which the projection carries into
    the logits."""
    jconfig, config = _configs()
    jdec, _ = _decoders(seed=5)
    jqdec, qdec = _quantized(jdec, bits)
    js = jdecode.make_stepper({"decoder": jqdec}, jconfig)
    ts = tdecode.make_stepper({"decoder": qdec}, config)
    jstate, state = js.init_state(B), ts.init_state(B)
    assert state[0].dtype == state[1].dtype == BF
    x = _rows(25, (B, E))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for t in range(3):
        jl, jstate = js.step(jstate, jx, t)
        tl, state = ts.step(state, tx, t)
        assert tl.dtype == BF and jl.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np32(tl), _np32(jl), rtol=0,
                                   atol=_tol(_np32(jl), STEPPER_UNITS))
        ids = np.asarray(jnp.argmax(jl, -1))
        jx, tx = js.embed(jnp.asarray(ids)), ts.embed(torch.from_numpy(ids))
        assert tx.dtype == BF


@pytest.mark.parametrize("bits", [8, 4])
def test_continuous_chunks_carry_bfloat16_state(bits):
    """The continuous engine's chunk (``decode_chunk``) at
    ``dtype="bfloat16"``: h and x stay bfloat16, c goes through the
    kernel in float32 and comes back in the carried dtype, as the JAX
    engine's ``cT.astype(state[1].dtype)``; two chunks of 3 against JAX's
    ``decode_sample_q_serve`` chunks."""
    jconfig, config = _configs()
    jdec, _ = _decoders(seed=11)
    jqdec, qdec = _quantized(jdec, bits)
    h, c = tdecode.make_stepper({"decoder": qdec}, config).init_state(B)
    x = torch.from_numpy(_rows(26, (B, E))).to(BF)
    jh, jc, jx = (jnp.asarray(_np32(t), jnp.bfloat16) for t in (h, c, x))
    for _ in range(2):
        ids_j, lps_j, (jh, jc32, jx) = jq_serve(
            jx, jqdec, 3, init_state=(jh, jc, jx), bits=bits)
        jc = jc32.astype(jnp.bfloat16)
        ids, lps, (h, c, x) = tdecode.decode_chunk(qdec, x, h, c, 3)
        assert (h.dtype, c.dtype, x.dtype) == (BF, BF, BF)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(lps.numpy(), np.asarray(lps_j), rtol=0,
                                   atol=_tol(lps_j))
        for a, b in ((h, jh), (c, jc), (x, jx)):
            np.testing.assert_allclose(_np32(a), _np32(b), rtol=0,
                                       atol=_tol(_np32(b), BF16_UNITS))


# ------------------------------------ the dense decode's bfloat16 modes

def _jax_bf16_args(jdec, feats):
    d = _bf16_tree(jdec)
    return (jnp.asarray(feats, jnp.bfloat16), d["lstm"], d["linear"]["w"],
            d["linear"]["b"], d["embed"])


def test_sample_resid_bfloat16_plain_matches_jax():
    """Mode ``sample_resid`` on bfloat16 weights and features (the JAX
    kernel's interpret mode draws zero uniforms; the port is fed zeros):
    ids, the bfloat16 soft sample and residuals hs, cs, gates."""
    jdec, gen = _decoders(seed=13)
    feats = _rows(27, (B, E))
    temp = float(jnp.asarray(2.0, jnp.bfloat16))
    ids_j, soft_j, hs_j, cs_j, g_j = jdecode_sample(
        *_jax_bf16_args(jdec, feats), T, mode="sample_resid",
        temperature=temp)
    layers, wp, bp, emb = _bf16_layers(gen)
    out = tks.decode_sample_resid(
        torch.from_numpy(feats).to(BF), layers, wp, bp, emb, T,
        temperature=temp, uniforms=torch.zeros(T, B, V))
    ids, soft, hs, cs, gates = out
    assert all(t.dtype == BF for t in (soft, hs, cs, gates))
    assert soft_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    for name, a, b in (("soft", soft, soft_j), ("hs", hs, hs_j),
                       ("cs", cs, cs_j), ("gates", gates, g_j)):
        np.testing.assert_allclose(_np32(a), _np32(b), rtol=0,
                                   atol=_tol(_np32(b), BF16_UNITS),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["greedy", "pretrain"])
def test_greedy_and_pretrain_bfloat16_plain_match_jax(mode):
    """Modes ``greedy`` (the free MLE step's ids) and ``pretrain`` (the
    MLE eval step's ids and bfloat16 logits) on bfloat16 weights."""
    jdec, gen = _decoders(seed=17)
    feats = _rows(28, (B, E))
    out_j = jdecode_sample(*_jax_bf16_args(jdec, feats), T, mode=mode)
    layers, wp, bp, emb = _bf16_layers(gen)
    out = tks.decode_sample(torch.from_numpy(feats).to(BF), layers, wp, bp,
                            emb, T, mode=mode)
    if mode == "greedy":
        ids, ids_j = out, out_j
    else:
        (ids, logits), (ids_j, logits_j) = out, out_j
        assert logits.dtype == BF and logits_j.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np32(logits), _np32(logits_j), rtol=0,
                                   atol=_tol(_np32(logits_j), BF16_UNITS))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))


def test_float32_only_modes_refuse_bfloat16():
    """Modes without a bfloat16 instantiation (``sample``, ``sample_embed``
    and the embed backward: the ``kernel_rescore`` and ``kernel_embed``
    routes) raise TypeError on bfloat16, on the CPU as on the card."""
    _, gen = _decoders()
    layers, wp, bp, emb = _bf16_layers(gen)
    feats = torch.zeros(B, E, dtype=BF)
    with pytest.raises(TypeError, match="float32"):
        tks.decode_sample(feats, layers, wp, bp, emb, T, mode="sample")
    with pytest.raises(TypeError, match="float32"):
        tks.decode_sample(feats, layers, wp, bp, emb, T, mode="sample_embed",
                          disc_embed=torch.zeros(4, V, dtype=BF))
    with pytest.raises(TypeError, match="float32"):
        tks.decode_sample(feats.to(torch.float16), *(
            [{k: v.to(torch.float16) for k, v in lp.items()} for lp in layers],
            wp.half(), bp.half(), emb.half()), T, mode="greedy")
