"""The port's ``ops/quantize.py`` against the JAX package's on the same
weights (numpy, from a seed): payloads byte for byte, scales within 1e-7
relative (both round half to even and divide in float32), for int8, int4
packed two per byte (even rows, and odd rows with the embedding's pad
row), and the whole quantized decoder; the int4 decoder on the JAX side
is its row-packed carrier (``GIC_INT4_PACK=1``).  Then the per-step
quantized math (``qmatmul``, the LSTM step, the embedding) within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_image_captioning_tpu.config import Config as JConfig
from gan_image_captioning_tpu.kernels.decode_sample import (
    pack_int4_rows as jpack_int4_rows)
from gan_image_captioning_tpu.models import generator as jgen
from gan_image_captioning_tpu.ops import quantize as jq
from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.interop import (generator_from_jax,
                                                    qdec_from_jax)
from gan_image_captioning_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

V, E, H = 256, 32, 32
SCALE_RTOL = 1e-7


def _w(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _assert_qt(port, jax_qt):
    np.testing.assert_array_equal(port.q.numpy(),
                                  np.asarray(jax_qt.q).astype(np.int8))
    assert port.q.dtype == torch.int8
    np.testing.assert_allclose(port.scale.numpy(), np.asarray(jax_qt.scale),
                               rtol=SCALE_RTOL, atol=0)
    assert tuple(port.scale.shape) == tuple(np.asarray(jax_qt.scale).shape)


def _assert_qdec(port, jax_qdec):
    _assert_qt(port["embed"], jax_qdec["embed"])
    for lp, lj in zip(port["lstm_q"], jax_qdec["lstm_q"]):
        _assert_qt(lp["w"], lj["w"])
        np.testing.assert_array_equal(lp["b"].numpy(), np.asarray(lj["b"]))
    _assert_qt(port["linear"]["w"], jax_qdec["linear"]["w"])
    np.testing.assert_array_equal(port["linear"]["b"].numpy(),
                                  np.asarray(jax_qdec["linear"]["b"]))


@pytest.fixture(scope="module")
def decoder():
    """(JAX decoder tree, the port Generator with its weights)."""
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, max_seq_len=6)
    jdec = jgen.init_decoder_params(jax.random.PRNGKey(5), jconfig)
    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=2, max_seq_len=6)
    tree = jax.tree_util.tree_map(np.asarray, {"decoder": jdec})
    return jdec, generator_from_jax(tree, config).requires_grad_(False)


@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((64, 48), 0),
                                        ((3, 5, 7), 1)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_jax(shape, axis, bits):
    w = _w(shape, 1)
    w[:, 0] = 0.0                            # a zero channel: scale 1
    got = tq.quantize(torch.from_numpy(w), channel_axis=axis, bits=bits)
    _assert_qt(got, jq.quantize(jnp.asarray(w), channel_axis=axis, bits=bits))
    back = tq.dequantize(got).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jq.dequantize(jq.quantize(jnp.asarray(w), axis,
                                                   bits=bits))),
        rtol=1e-7, atol=0)


def test_quantize_rounds_half_to_even():
    """Values that land exactly on .5 after the scale: both sides round to
    the even neighbour."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32).T
    got = tq.quantize(torch.from_numpy(w), channel_axis=-1)
    assert got.q[:, 0].tolist() == [127, 0, 2, 2, 0, -2]
    _assert_qt(got, jq.quantize(jnp.asarray(w), channel_axis=-1))


@pytest.mark.parametrize("rows,pad_odd", [(64, False), (65, True)])
def test_quantize_packed_int4_matches_jax(rows, pad_odd):
    w = _w((rows, 24), 2)
    got = tq.quantize_packed_int4(torch.from_numpy(w), pad_odd=pad_odd)
    _assert_qt(got, jq.quantize_packed_int4(w, pad_odd=pad_odd))
    assert got.q.shape[0] == -(-rows // 2)
    if pad_odd:   # the pad row is all zero: the high nibbles of the last row
        assert (tq.unpack_int4_rows(got.q)[-1] == 0).all()


def test_packed_int4_odd_rows_without_pad_raise():
    with pytest.raises(ValueError, match="even row count"):
        tq.quantize_packed_int4(torch.from_numpy(_w((5, 4), 3)))


def test_pack_and_unpack_rows_match_jax():
    q = np.random.default_rng(4).integers(-7, 8, size=(40, 12)).astype(
        np.int8)
    packed = tq.pack_int4_rows(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpack_int4_rows(q)))
    np.testing.assert_array_equal(tq.unpack_int4_rows(packed).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_int4_rows(packed).numpy(),
        np.asarray(jq.unpack_int4_rows(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_lstm_decoder_matches_jax(decoder, bits):
    jdec, gen = decoder
    port = tq.quantize_lstm_decoder(gen.decoder, bits)
    ref = jq.quantize_lstm_decoder(jdec, bits=bits, pack_int4=bits == 4)
    _assert_qdec(port, ref)
    assert tq.payload_bits(port) == jq.payload_bits(ref) == bits
    # and the bridge hands the JAX tree over unchanged
    _assert_qdec(qdec_from_jax(jax.tree_util.tree_map(np.asarray, ref)), ref)


@pytest.mark.parametrize("quantize,bits", [("int8", 8), ("int4", 4)])
def test_quantize_generator_follows_the_flag(decoder, monkeypatch, quantize,
                                             bits):
    monkeypatch.setenv("GIC_INT4_PACK", "1")
    jdec, gen = decoder
    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=2, quantize=quantize)
    jconfig = JConfig(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                      gen_num_layers=2, quantize=quantize)
    assert tq.config_bits(config) == jq.config_bits(jconfig) == bits
    port = tq.quantize_generator(gen, config)
    _assert_qdec(port["decoder"],
                 jq.quantize_generator({"decoder": jdec}, jconfig)["decoder"])
    assert tq.is_quantized(port["decoder"]) and not tq.is_quantized(
        gen.decoder)


def test_quantize_generator_refuses_a_transformer(decoder):
    """A transformer is no longer refused: its twin is a fake-quantized
    transformer generator, not a quantized LSTM decoder (its values
    against the JAX twin: ``test_torch_port_serve_tf_slots.py``)."""
    from gan_image_captioning_tpu_torch.models.transformer import (
        TransformerGenerator, init_transformer_generator_params)

    config = Config(vocab_size=40, gen_arch="transformer", gen_num_heads=2,
                    gen_embed_dim=32, gen_hidden_dim=128, gen_num_layers=1,
                    quantize="int8")
    gen = init_transformer_generator_params(torch.Generator(), config)
    twin = tq.quantize_generator(gen, config)
    assert isinstance(twin, TransformerGenerator)
    assert not tq.is_quantized(twin.decoder)
    w = twin.decoder.blocks[0].mlp.fc1.w
    assert not torch.equal(w, gen.decoder.blocks[0].mlp.fc1.w)
    scale = w.abs().amax(dim=0) / 127
    torch.testing.assert_close(w / scale, torch.round(w / scale), atol=1e-4,
                               rtol=0)


def test_qmatmul_matches_jax():
    w, x = _w((48, 40), 6), _w((5, 48), 7)
    qt = tq.quantize(torch.from_numpy(w))
    got = tq.qmatmul(torch.from_numpy(x), qt)
    ref = jq.qmatmul(jnp.asarray(x), jq.quantize(jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_quantized_step_and_embed_match_jax(decoder):
    jdec, gen = decoder
    jqdec = jq.quantize_lstm_decoder(jdec, bits=8)
    qdec = qdec_from_jax(jax.tree_util.tree_map(np.asarray, jqdec))
    B = 3
    x = _w((B, E), 8)
    h, c = _w((2, B, H), 9, 0.5), _w((2, B, H), 10, 0.5)
    top, (h2, c2) = tq.quantized_lstm_step(
        qdec, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    jtop, (jh2, jc2) = jq.quantized_lstm_step(
        jqdec, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    for a, b in ((top, jtop), (h2, jh2), (c2, jc2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    ids = np.array([0, 5, V - 1], np.int32)
    np.testing.assert_allclose(
        tq.quantized_embed(qdec, torch.from_numpy(ids)).numpy(),
        np.asarray(jq.quantized_embed(jqdec, jnp.asarray(ids))),
        rtol=1e-7, atol=0)


def test_qdec_from_jax_refuses_native_int4(decoder):
    jdec, _ = decoder
    native = jq.quantize_lstm_decoder(jdec, bits=4, pack_int4=False)
    with pytest.raises(TypeError, match="int8"):
        qdec_from_jax(native)
