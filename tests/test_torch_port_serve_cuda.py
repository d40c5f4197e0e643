"""The carried-state serve kernel and the quantized serve kernel against
their plain PyTorch versions, and the continuous engine through them, on
the card.  Every test skips without CUDA.  This file imports torch and the
port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_serve_cuda.py

Tolerances: ids exact; logprobs and the carried (h, c) within 1e-4 of the
plain versions (float32 sums in another order); chunks of the carried
kernel against one full kernel decode within 1e-6 (the same operations).
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as tdecode
from gan_image_captioning_tpu_torch.kernels import decode_sample as tks
from gan_image_captioning_tpu_torch.models.generator import (
    init_generator_params)
from gan_image_captioning_tpu_torch.ops import quantize as tq
from gan_image_captioning_tpu_torch.serving import ContinuousBatcher

ATOL, CHAIN_ATOL = 1e-4, 1e-6

# a batch tile edge (33), vocabulary tile edges (300 = 4*64 + 44, and the
# odd 301 with the int4 embedding's pad row), E != H, H % 4 != 0
SHAPES = [(1, 300, 48, 40, 2, 7), (5, 256, 32, 32, 1, 9),
          (33, 301, 48, 42, 3, 6)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _generator(V, E, H, nl, T, device, seed=0):
    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=nl, max_seq_len=T - 2)
    gen = init_generator_params(torch.Generator().manual_seed(seed), config,
                                device, sweep=False)
    return config, gen.requires_grad_(False)


def _args(dec, x, steps):
    return (x, dec.lstm.layers(), dec.linear.weight, dec.linear.bias,
            dec.embed.weight, steps)


def _rows(B, E, device, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, E)).astype(np.float32)).to(device)


def _zero_state(nl, B, H, device):
    return (torch.zeros(nl, B, H, device=device),
            torch.zeros(nl, B, H, device=device))


@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_carried_chunks_equal_the_full_kernel(device, B, V, E, H, nl, T):
    _, gen = _generator(V, E, H, nl, T, device)
    feats = _rows(B, E, device, B)
    ids, lps = tks.decode_sample(*_args(gen.decoder, feats, T), mode="serve")
    h, c = _zero_state(nl, B, H, device)
    x, parts, t = feats, [], 0
    while t < T:
        k = min(3, T - t)
        i, lp, (h, c, x) = tks.decode_sample(
            *_args(gen.decoder, x, k), mode="serve", init_state=(h, c, x))
        parts.append((i, lp))
        t += k
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([p[0] for p in parts], 1), ids)
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 1), lps,
                               atol=CHAIN_ATOL, rtol=0)


@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_carried_kernel_matches_plain(device, B, V, E, H, nl, T):
    _, gen = _generator(V, E, H, nl, T, device, seed=1)
    g = torch.Generator(device=device).manual_seed(B)
    state = (torch.randn(nl, B, H, generator=g, device=device) * 0.5,
             torch.randn(nl, B, H, generator=g, device=device) * 0.5,
             _rows(B, E, device, B + 1))
    before = tks.decode_sample_carry.launches
    ids, lps, (hT, cT, xT) = tks.decode_sample_carry(
        *_args(gen.decoder, state[2], T), init_state=state)
    assert tks.decode_sample_carry.launches == before + 1
    ids_p, lps_p, (h_p, c_p, x_p) = tks.decode_sample_plain(
        *_args(gen.decoder, state[2], T), init_state=state)
    torch.cuda.synchronize()
    assert torch.equal(ids, ids_p)
    for a, b in ((lps, lps_p), (hT, h_p), (cT, c_p), (xT, x_p)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_q_serve_kernel_matches_plain(device, B, V, E, H, nl, T, bits,
                                      carry):
    _, gen = _generator(V, E, H, nl, T, device, seed=2)
    qdec = tq.quantize_lstm_decoder(gen.decoder, bits)
    feats = _rows(B, E, device, B + 2)
    state = (*_zero_state(nl, B, H, device), feats) if carry else None
    before = tks.decode_sample_q_serve.launches
    out = tks.decode_sample_q_serve(feats, qdec, T, init_state=state,
                                    bits=bits)
    assert tks.decode_sample_q_serve.launches == before + 1
    ref = tks.decode_sample_q_serve_plain(feats, qdec, T, init_state=state,
                                          bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0])
    torch.testing.assert_close(out[1], ref[1], atol=ATOL, rtol=0)
    if carry:
        for a, b in zip(out[2], ref[2]):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    # the dense kernel on the dequantized weights: the same products
    layers, w_proj, b_proj, embed = tks.dequantized_decoder(qdec, bits)
    ids_d, lps_d = tks.decode_sample(feats, layers, w_proj, b_proj, embed,
                                     T, mode="serve")
    assert torch.equal(out[0], ids_d)
    torch.testing.assert_close(out[1], lps_d, atol=CHAIN_ATOL, rtol=0)


def test_malformed_cuda_calls_raise_and_launch_nothing(device):
    V, E, H, T, B = 256, 32, 32, 4, 2
    _, gen = _generator(V, E, H, 2, T + 2, device)
    q8 = tq.quantize_lstm_decoder(gen.decoder, 8)
    q4 = tq.quantize_lstm_decoder(gen.decoder, 4)
    feats = _rows(B, E, device, 0)
    h, c = _zero_state(2, B, H, device)
    counters = (tks.decode_sample, tks.decode_sample_carry,
                tks.decode_sample_q_serve)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="shape"):
        tks.decode_sample_q_serve(feats, q8, T, bits=4)
    with pytest.raises(ValueError, match="shape"):
        tks.decode_sample_q_serve(feats, q4, T, bits=8)
    cpu_scale = dict(q8, embed=tq.QTensor(q8["embed"].q,
                                          q8["embed"].scale.cpu()))
    with pytest.raises(ValueError, match="cpu"):
        tks.decode_sample_q_serve(feats, cpu_scale, T)
    with pytest.raises(TypeError):
        tks.decode_sample_q_serve(feats.double(), q8, T)
    with pytest.raises(ValueError, match="h0"):
        tks.decode_sample_q_serve(feats, q8, T,
                                  init_state=(h[:1], c, feats))
    with pytest.raises(ValueError, match="c0"):
        tks.decode_sample(*_args(gen.decoder, feats, T), mode="serve",
                          init_state=(h, c.cpu(), feats))
    with pytest.raises(ValueError, match="contiguous"):
        tks.decode_sample(*_args(gen.decoder, feats, T), mode="serve",
                          init_state=(h.transpose(1, 2).contiguous()
                                      .transpose(1, 2), c, feats))
    with pytest.raises(NotImplementedError):
        tks.decode_sample(*_args(gen.decoder, feats, T), mode="greedy",
                          init_state=(h, c, feats))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
def test_continuous_batcher_launches_once_per_device_call(device, quantize):
    """The engine on the card: every chunk is one launch of the carried
    kernel (dense) or of the quantized serve kernel, and the captions
    equal the full-T batch decode of the same decoder (exact mode)."""
    V, E, H, nl, T, B = 300, 48, 40, 2, 11, 6
    config, gen = _generator(V, E, H, nl, T, device, seed=4)
    config = config.replace(quantize=quantize)
    params = gen if quantize == "none" else tq.quantize_generator(gen, config)
    counter = (tks.decode_sample_carry if quantize == "none"
               else tks.decode_sample_q_serve)
    feats = _rows(B, E, device, 5)
    want, _ = tdecode.greedy_with_logprobs(params, feats, config)
    before = counter.launches
    eng = ContinuousBatcher(params, config, num_slots=4, chunk_steps=4,
                            early_exit=False)
    try:
        futs = [eng.submit(row) for row in feats.cpu().numpy()]
        got = np.stack([f.result(timeout=120)[0] for f in futs])
    finally:
        eng.close()
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert eng.device_calls > 0
    assert counter.launches - before == eng.device_calls


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_adaptive_decode_runs_the_carried_kernels(device, quantize):
    V, E, H, nl, T, B = 300, 48, 40, 2, 11, 5
    config, gen = _generator(V, E, H, nl, T, device, seed=6)
    params = (gen if quantize == "none"
              else tq.quantize_generator(gen, config.replace(
                  quantize=quantize)))
    counter = (tks.decode_sample_carry if quantize == "none"
               else tks.decode_sample_q_serve)
    feats = _rows(B, E, device, 7)
    ids_f, lp_f = tdecode.greedy_with_logprobs(params, feats, config)
    before = counter.launches
    ids_a, lp_a = tdecode.greedy_with_logprobs_adaptive(params, feats,
                                                        config, chunk=4)
    assert 1 <= counter.launches - before <= 3     # ceil(11 / 4) at most
    for row_a, row_f in zip(ids_a.tolist(), ids_f.tolist()):
        upto = row_f.index(2) + 1 if 2 in row_f else len(row_f)   # <E> = 2
        assert row_a[:upto] == row_f[:upto]
        assert all(i == 0 for i in row_a[upto:])                  # <PAD>
    torch.testing.assert_close(lp_a, lp_f, atol=1e-4, rtol=0)
