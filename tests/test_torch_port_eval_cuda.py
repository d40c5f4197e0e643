"""Beam search and sampling on the card (``eval/decode.py``): the tie
order of ``beam_topk`` on CUDA tensors, and ``beam_search``,
``diverse_beam_search`` and ``sample_decode`` (fed noise) on the card
against the same calls on the CPU with the same weights.  Every test skips
without CUDA.  This file imports torch and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_eval_cuda.py

Tolerances: ids equal (the decoder's weights are scaled by 8 so that each
step's distribution is peaked, as a trained model's is: at their initial
scale near-equal beams are decided by the order of float32 sums), scores
and log-probabilities within 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.eval import decode as decode_lib
from gan_image_captioning_tpu_torch.models.api import init_generator

ATOL = 1e-4
PEAK = 8.0


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _generator(arch, seed=0):
    config = Config(vocab_size=300, gen_embed_dim=32, gen_hidden_dim=32,
                    gen_num_layers=2, gen_num_heads=4, max_seq_len=10,
                    gen_arch=arch)
    gen = init_generator(torch.Generator().manual_seed(seed), config)
    with torch.no_grad():
        for p in gen.decoder.parameters():
            p.mul_(PEAK)
    return gen.requires_grad_(False), config


def test_beam_topk_ties_go_to_the_lower_index(device):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4 * 11008)).astype(np.float32)
    x[:, 5000:5040] = x.max(axis=1, keepdims=True) + 1.0   # 40-way top tie
    x[1, :] = 0.5                                           # a tied row
    x[2, ::7] = -1e9
    want = np.argsort(-x, axis=1, kind="stable")[:, :8]
    vals, idx = decode_lib.beam_topk(torch.from_numpy(x).to(device), 8)
    np.testing.assert_array_equal(idx.cpu().numpy(), want)
    np.testing.assert_array_equal(vals.cpu().numpy(),
                                  np.take_along_axis(x, want, axis=1))


def _both(gen, device, fn):
    """``fn(generator, features)`` on the CPU and on the card."""
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32)).astype(np.float32))
    cpu = fn(gen, feats)
    card = fn(copy.deepcopy(gen).to(device), feats.to(device))
    return cpu, tuple(t.cpu() for t in card)


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_beam_search_card_equals_cpu(device, arch):
    gen, config = _generator(arch)
    cpu, card = _both(gen, device, lambda g, f: decode_lib.beam_search(
        g, f, config, beam_size=4, length_penalty=0.6))
    np.testing.assert_array_equal(card[0].numpy(), cpu[0].numpy())
    np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(), atol=ATOL)


def test_diverse_beam_search_card_equals_cpu(device):
    gen, config = _generator("lstm", seed=2)
    cpu, card = _both(gen, device, lambda g, f: (
        decode_lib.diverse_beam_search(g, f, config, beam_size=4,
                                       num_groups=2)))
    np.testing.assert_array_equal(card[0].numpy(), cpu[0].numpy())
    np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(), atol=ATOL)


@pytest.mark.parametrize("knobs", [dict(), dict(top_k=5, top_p=0.9),
                                   dict(no_repeat_ngram=3, min_length=2,
                                        repetition_penalty=1.3,
                                        early_stop=True)])
def test_sample_decode_card_equals_cpu(device, knobs):
    gen, config = _generator("lstm", seed=3)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(
        size=(config.seq_len, 4, config.vocab_size)).astype(np.float32))

    def run(g, f):
        return decode_lib.sample_decode(g, f, config,
                                        noise=noise.to(f.device), **knobs)

    cpu, card = _both(gen, device, run)
    np.testing.assert_array_equal(card[0].numpy(), cpu[0].numpy())
    np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(), atol=ATOL)


def test_sample_decode_draws_on_the_card(device):
    gen, config = _generator("lstm", seed=5)
    gen = gen.to(device)
    feats = torch.zeros((8, 32), device=device)

    def run(seed):
        rng = torch.Generator(device=device).manual_seed(seed)
        return decode_lib.sample_decode(gen, feats, config, rng,
                                        temperature=2.0)[0]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
