"""The carried-state serve decode and the quantized serve decode of the
port (on CPU tensors: their plain versions) against the JAX package's
``decode_sample(mode="serve", init_state=…)`` and ``decode_sample_q_serve``
run in interpret mode, on the same weights, quantized payloads and feature
rows (numpy, from a seed): ids equal, logprobs and the carried state
within 1e-5.  Then the decode functions built on them
(``eval/decode.py``): the adaptive chunked decode (ids equal, the tail
after ``<E>`` ``<PAD>``, sums within 1e-4), greedy and sequence logprobs
of a quantized decoder, and the steppers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.data.vocab import END, PAD
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
from gan_image_captioning_tpu_torch.ops import quantize as tq

B, T, V, H, E = 4, 8, 256, 32, 32
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIC_KERNEL_INTERPRET", "1")


def _configs():
    kw = dict(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
              gen_num_layers=2, max_seq_len=T - 2)
    return JConfig(**kw), Config(**kw)


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _decoders(end_bias=0.0, seed=3):
    """(JAX decoder tree, port Generator) on the same weights; ``end_bias``
    is added to the ``<E>`` logit's bias."""
    jconfig, config = _configs()
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(seed), jconfig)
    tree = jax.tree_util.tree_map(np.asarray, {"decoder": jdec})
    tree["decoder"]["linear"]["b"] = tree["decoder"]["linear"]["b"].copy()
    tree["decoder"]["linear"]["b"][END] += end_bias
    jdec = dict(jdec, linear=dict(jdec["linear"], b=jnp.asarray(
        tree["decoder"]["linear"]["b"])))
    return jdec, generator_from_jax(tree, config).requires_grad_(False)


def _quantized(jdec, bits):
    """(JAX quantized decoder, the port's conversion of it)."""
    jqdec = jq.quantize_lstm_decoder(jdec, bits=bits, pack_int4=bits == 4)
    return jqdec, qdec_from_jax(jax.tree_util.tree_map(np.asarray, jqdec))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _port_args(gen, x, steps):
    dec = gen.decoder
    return (x, dec.lstm.layers(), dec.linear.weight, dec.linear.bias,
            dec.embed.weight, steps)


def _state(seed, nl=2, b=B):
    return (_rows(seed, (nl, b, H), 0.5), _rows(seed + 1, (nl, b, H), 0.5),
            _rows(seed + 2, (b, E)))


@pytest.mark.parametrize("steps", [T, 3])
def test_carried_dense_plain_matches_jax(steps):
    jdec, gen = _decoders()
    h0, c0, x0 = _state(10)
    ids_j, lps_j, (h_j, c_j, x_j) = jdecode_sample(
        jnp.asarray(x0), jdec["lstm"], jdec["linear"]["w"],
        jdec["linear"]["b"], jdec["embed"], steps, mode="serve",
        init_state=(jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(x0)))
    state = tuple(torch.from_numpy(a) for a in (h0, c0, x0))
    ids, lps, (hT, cT, xT) = tks.decode_sample(
        *_port_args(gen, state[2], steps), mode="serve", init_state=state)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    assert len(np.unique(np.asarray(ids_j))) > 2
    for a, b in ((lps, lps_j), (hT, h_j), (cT, c_j), (xT, x_j)):
        _close(a.numpy(), b)


def test_carried_chunks_equal_one_full_decode():
    """Chunks of 3, 3 and 2 steps through the carried state give the full
    decode's ids and logprobs exactly (the same operations in order)."""
    _, gen = _decoders()
    feats = torch.from_numpy(_rows(20, (B, E)))
    ids, lps = tks.decode_sample(*_port_args(gen, feats, T), mode="serve")
    h = c = torch.zeros(2, B, H)
    x, parts = feats, []
    for k in (3, 3, 2):
        i, lp, (h, c, x) = tks.decode_sample_carry(
            *_port_args(gen, x, k), init_state=(h, c, x))
        parts.append((i, lp))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), ids)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), lps)


@pytest.mark.parametrize("bits", [8, 4])
def test_q_serve_plain_matches_jax(bits):
    jdec, _ = _decoders(seed=7)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(21, (B, E))
    ids_j, lps_j = jq_serve(jnp.asarray(feats), jqdec, T, bits=bits)
    ids, lps = tks.decode_sample_q_serve(torch.from_numpy(feats), qdec, T,
                                         bits=bits)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    assert len(np.unique(np.asarray(ids_j))) > 2
    _close(lps.numpy(), lps_j)


@pytest.mark.parametrize("bits", [8, 4])
def test_q_serve_chunks_match_jax(bits):
    """K = 4 chunks through the carried state on both sides: every
    chunk's ids, logprobs and state agree, and the chain equals the full
    decode."""
    jdec, _ = _decoders(seed=11)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(22, (B, E))
    jh = jnp.zeros((2, B, H), jnp.float32)
    jc, jx = jh, jnp.asarray(feats)
    h = c = torch.zeros(2, B, H)
    x = torch.from_numpy(feats)
    ids_all = []
    for _ in range(T // 4):
        ids_j, lps_j, (jh, jc, jx) = jq_serve(jx, jqdec, 4,
                                              init_state=(jh, jc, jx),
                                              bits=bits)
        ids, lps, (h, c, x) = tks.decode_sample_q_serve(
            x, qdec, 4, init_state=(h, c, x), bits=bits)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        for a, b in ((lps, lps_j), (h, jh), (c, jc), (x, jx)):
            _close(a.numpy(), b)
        ids_all.append(ids)
    full, _ = tks.decode_sample_q_serve(torch.from_numpy(feats), qdec, T,
                                        bits=bits)
    assert torch.equal(torch.cat(ids_all, dim=1), full)


@pytest.mark.parametrize("bits", [8, 4])
def test_q_serve_equals_dense_decode_on_dequantized_weights(bits):
    """The JAX package's exactness check (tests/test_quantized_kernel.py):
    the quantized decode is the dense decode on the dequantized weights."""
    jdec, _ = _decoders(seed=5)
    _, qdec = _quantized(jdec, bits)
    feats = torch.from_numpy(_rows(23, (B, E)))
    ids, lps = tks.decode_sample_q_serve(feats, qdec, T, bits=bits)
    layers, w_proj, b_proj, embed = tks.dequantized_decoder(qdec, bits)
    ids_d, lps_d = tks.decode_sample(feats, layers, w_proj, b_proj, embed,
                                     T, mode="serve")
    assert torch.equal(ids, ids_d) and torch.equal(lps, lps_d)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("end_bias", [0.0, 4.0, 100.0])
def test_adaptive_matches_jax(kind, end_bias):
    """Random rows decode to the end (no <E>), a raised <E> bias ends rows
    at different steps, a large one ends every row at t = 0 (one chunk)."""
    jconfig, config = _configs()
    jdec, gen = _decoders(end_bias=end_bias, seed=13)
    if kind == "dense":
        jparams, params = {"decoder": jdec}, gen
    else:
        jqdec, qdec = _quantized(jdec, 8 if kind == "int8" else 4)
        jparams, params = {"decoder": jqdec}, {"decoder": qdec}
    feats = _rows(24, (B, E))
    ids_j, lp_j = jdecode.greedy_with_logprobs_adaptive(
        jparams, jnp.asarray(feats), jconfig, chunk=3)
    ids, lp = tdecode.greedy_with_logprobs_adaptive(
        params, torch.from_numpy(feats), config, chunk=3)
    ids_j = np.asarray(ids_j)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    _close(lp.numpy(), lp_j, atol=1e-4)
    for row in ids_j:               # the tail after the first <E> is <PAD>
        ends = np.flatnonzero(row == END)
        if ends.size:
            assert (row[ends[0] + 1:] == PAD).all()
    if end_bias == 100.0:
        assert (ids_j[:, 0] == END).all()


def test_adaptive_stops_after_the_chunk_where_every_row_ended(monkeypatch):
    """With every caption ending at t = 0 the adaptive decode runs one
    chunk of the carried decode, not ceil(T / K)."""
    _, config = _configs()
    _, gen = _decoders(end_bias=100.0)
    calls = []
    real = tdecode.decode_chunk
    monkeypatch.setattr(tdecode, "decode_chunk",
                        lambda *a: calls.append(a[-1]) or real(*a))
    ids, _ = tdecode.greedy_with_logprobs_adaptive(
        gen, torch.from_numpy(_rows(25, (B, E))), config, chunk=3)
    assert calls == [3]
    assert (ids[:, 0] == END).all() and (ids[:, 1:] == PAD).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_greedy_and_logprobs_match_jax(bits):
    jconfig, config = _configs()
    jdec, _ = _decoders(seed=17)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(26, (B, E))
    ids_j = np.asarray(jdecode.greedy({"decoder": jqdec}, jnp.asarray(feats),
                                      jconfig))
    ids = tdecode.greedy({"decoder": qdec}, torch.from_numpy(feats), config)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    ids2, lp = tdecode.greedy_with_logprobs({"decoder": qdec},
                                            torch.from_numpy(feats), config)
    ids2_j, lp_j = jdecode.greedy_with_logprobs({"decoder": jqdec},
                                                jnp.asarray(feats), jconfig)
    np.testing.assert_array_equal(ids2.numpy(), np.asarray(ids2_j))
    _close(lp.numpy(), lp_j, atol=1e-4)
    # the teacher-forced score of the same ids through the quantized stepper
    seq = tdecode.sequence_logprob({"decoder": qdec},
                                   torch.from_numpy(feats), ids, config)
    seq_j = jdecode.sequence_logprob({"decoder": jqdec}, jnp.asarray(feats),
                                     jnp.asarray(ids_j), jconfig)
    _close(seq.numpy(), seq_j, atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_stepper_greedy_matches_jax(bits):
    jconfig, config = _configs()
    jdec, _ = _decoders(seed=19)
    jqdec, qdec = _quantized(jdec, bits)
    feats = _rows(27, (B, E))
    ids_j = jdecode._stepper_greedy(
        jdecode.quantized_lstm_stepper(jqdec, jconfig, dtype=jnp.float32),
        jnp.asarray(feats), T)
    stepper = tdecode.make_stepper({"decoder": qdec}, config)
    ids = tdecode._stepper_greedy(stepper, torch.from_numpy(feats), T)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    _, gen = _decoders()
    assert tdecode.kernel_quantized_available(qdec)
    assert not tdecode.kernel_quantized_available(gen.decoder)
    # the dense stepper is the dense greedy decode
    dense = tdecode._stepper_greedy(tdecode.lstm_stepper(gen.decoder),
                                    torch.from_numpy(feats), T)
    assert torch.equal(dense, tdecode.greedy(gen, torch.from_numpy(feats),
                                             config))


def test_cpu_calls_count_no_launch():
    jdec, gen = _decoders()
    _, qdec = _quantized(jdec, 8)
    counters = (tks.decode_sample, tks.decode_sample_carry,
                tks.decode_sample_q_serve)
    before = [f.launches for f in counters]
    feats = torch.from_numpy(_rows(28, (B, E)))
    state = (torch.zeros(2, B, H), torch.zeros(2, B, H), feats)
    tks.decode_sample(*_port_args(gen, feats, 3), mode="serve",
                      init_state=state)
    tks.decode_sample_q_serve(feats, qdec, 3, init_state=state)
    tks.decode_sample_q_serve(feats, qdec, 3)
    assert [f.launches for f in counters] == before


def test_q_serve_rejects_bad_inputs():
    jdec, _ = _decoders()
    _, q8 = _quantized(jdec, 8)
    _, q4 = _quantized(jdec, 4)
    feats = torch.from_numpy(_rows(29, (B, E)))
    with pytest.raises(ValueError, match="shape"):      # bits 4 on int8
        tks.decode_sample_q_serve(feats, q8, T, bits=4)
    with pytest.raises(ValueError, match="shape"):      # bits 8 on packed
        tks.decode_sample_q_serve(feats, q4, T, bits=8)
    with pytest.raises(ValueError, match="bits"):
        tks.decode_sample_q_serve(feats, q8, T, bits=2)
    bad = dict(q8, linear={"w": tq.QTensor(q8["linear"]["w"].q.float(),
                                           q8["linear"]["w"].scale),
                           "b": q8["linear"]["b"]})
    with pytest.raises(TypeError):
        tks.decode_sample_q_serve(feats, bad, T)
    with pytest.raises(ValueError, match="h0"):
        tks.decode_sample_q_serve(feats, q8, T, init_state=(
            torch.zeros(1, B, H), torch.zeros(2, B, H), feats))
    with pytest.raises(ValueError, match="init_state"):
        tks.decode_sample_q_serve(feats, q8, T, init_state=(feats,))
    with pytest.raises(ValueError):
        tks.decode_sample_q_serve(feats.to("meta"), q8, T)
