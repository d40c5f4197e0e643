"""The decode modes ``sample``, ``pretrain`` and ``sample_embed`` and the
fused-embed backward against their plain PyTorch versions on the card,
and the training steps of the decode routes ``kernel_rescore``,
``kernel_embed`` and ``decoupled`` through them.  Every test skips
without CUDA.  This file imports torch and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_decode_modes_cuda.py

Tolerances: ids exact (the plain versions' argmax on the same scores);
noise 1e-5; logits, soft, residuals 1e-4; emb and d_htop 1e-5 and dWp /
dbp 1e-4 of their largest entry (float32 sums in another order); step
losses 1e-5 and gradients 1e-4 of each tensor's largest entry.
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_embed, decode_sample_embed_bwd,
    decode_sample_embed_bwd_plain, decode_sample_embed_plain,
    decode_sample_logits, decode_sample_logits_plain, decode_sample_noise,
    decode_sample_noise_plain, decode_sample_resid)
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_reverse)
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, device, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(device)


def _decoder(rng, V, E, H, nl, device):
    k = 1.0 / np.sqrt(H)
    layers = [{"w_ih": _t(rng, device, 4 * H, E if l == 0 else H, scale=k),
               "w_hh": _t(rng, device, 4 * H, H, scale=k),
               "b_ih": _t(rng, device, 4 * H, scale=k),
               "b_hh": _t(rng, device, 4 * H, scale=k)} for l in range(nl)]
    return (layers, _t(rng, device, V, H, scale=k),
            _t(rng, device, V, scale=0.1), _t(rng, device, V, E))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# a batch tile edge (33), a vocabulary tile edge (300 = 4*64 + 44), E != H,
# one to three layers, an embedding width past one tile (70 > 64)
SIZES = [(1, 300, 48, 40, 2, 7, 20), (33, 300, 48, 42, 3, 6, 70)]


def _setup(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(B * 100 + nl)
    layers, w, b, emb = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    u = torch.rand((T, B, V), generator=torch.Generator(device=device)
                   .manual_seed(B), device=device)
    return rng, (feats, layers, w, b, emb, T), u


@pytest.mark.parametrize("B,V,E,H,nl,T,Ed", SIZES)
def test_sample_mode_matches_plain_and_sample_resid(device, B, V, E, H, nl,
                                                    T, Ed):
    _, args, u = _setup(device, B, V, E, H, nl, T)
    ids, noise = decode_sample_noise(*args, uniforms=u)
    ids_p, noise_p = decode_sample_noise_plain(*args, u)
    ids_r = decode_sample_resid(*args, temperature=3.0, uniforms=u)[0]
    seeded = decode_sample_noise(*args, seed=5)[0]
    seeded_r = decode_sample_resid(*args, seed=5)[0]
    torch.cuda.synchronize()
    assert torch.equal(ids, ids_r) and torch.equal(seeded, seeded_r)
    assert torch.equal(ids, ids_p)
    torch.testing.assert_close(noise, noise_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,V,E,H,nl,T,Ed", SIZES)
def test_pretrain_mode_matches_plain_and_greedy(device, B, V, E, H, nl, T,
                                                Ed):
    _, args, _ = _setup(device, B, V, E, H, nl, T)
    ids, logits = decode_sample_logits(*args)
    ids_p, logits_p = decode_sample_logits_plain(*args)
    greedy = decode_sample(*args, mode="greedy")
    torch.cuda.synchronize()
    assert torch.equal(ids, greedy) and torch.equal(ids, ids_p)
    torch.testing.assert_close(logits, logits_p, atol=1e-4, rtol=0)


@pytest.mark.parametrize("B,V,E,H,nl,T,Ed", SIZES)
def test_sample_embed_matches_plain_and_sample_resid(device, B, V, E, H, nl,
                                                     T, Ed):
    rng, args, u = _setup(device, B, V, E, H, nl, T)
    wd = _t(rng, device, Ed, V, scale=0.1)
    got = decode_sample_embed(*args, wd, temperature=3.0, uniforms=u)
    want = decode_sample_embed_plain(*args, u, 3.0, wd)
    resid = decode_sample_resid(*args, temperature=3.0, uniforms=u)
    torch.cuda.synchronize()
    ids, emb, soft, *res = got
    assert torch.equal(ids, resid[0]) and torch.equal(ids, want[0])
    for a, c in zip((soft, *res), resid[1:]):
        assert torch.equal(a, c)
    torch.testing.assert_close(soft, want[2], atol=1e-5, rtol=0)
    assert _rel(emb, (soft.double() @ wd.double().T).float()) <= 1e-5
    assert _rel(emb, want[1]) <= 1e-5


@pytest.mark.parametrize("T,B,H,V,Ed", [(3, 5, 40, 300, 20),
                                        (6, 33, 70, 130, 70)])
def test_embed_bwd_matches_plain(device, T, B, H, V, Ed):
    rng = np.random.default_rng(T * B)
    soft = torch.softmax(_t(rng, device, T, B, V, scale=3.0), dim=-1)
    args = (_t(rng, device, T, B, H), soft, _t(rng, device, T, B, Ed),
            _t(rng, device, V, H, scale=0.2), _t(rng, device, Ed, V,
                                                 scale=0.1), 4.0)
    got = decode_sample_embed_bwd(*args)
    want = decode_sample_embed_bwd_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (H, V) and got[1].shape == (V,)
    assert got[2].shape == (T, B, H)
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4
    assert _rel(got[2], want[2]) <= 1e-5


def test_malformed_calls_raise_and_count_no_launch(device):
    rng = np.random.default_rng(2)
    _, args, u = _setup(device, 2, 64, 8, 8, 1, 3)
    wd = _t(rng, device, 4, 64)
    fns = (decode_sample_noise, decode_sample_logits, decode_sample_embed,
           decode_sample_embed_bwd)
    before = [f.launches for f in fns]
    with pytest.raises(ValueError):
        decode_sample_noise(*args, uniforms=u[:, :, :63].contiguous())
    with pytest.raises(TypeError):
        decode_sample_logits(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        decode_sample_embed(*args, wd[:, :63].contiguous())
    with pytest.raises(ValueError):
        decode_sample(*args, mode="sample_embed")
    h_top = _t(rng, device, 3, 2, 8)
    with pytest.raises(TypeError):
        decode_sample_embed_bwd(h_top, u.double(), _t(rng, device, 3, 2, 4),
                                args[2], wd, 1.0)
    with pytest.raises(ValueError):
        decode_sample_embed_bwd(h_top.cpu(), u, _t(rng, device, 3, 2, 4),
                                args[2], wd, 1.0)
    assert [f.launches for f in fns] == before


def _step_setup(device):
    config = Config(vocab_size=300, gen_embed_dim=24, gen_hidden_dim=20,
                    gen_num_layers=2, max_seq_len=5, disc_embed_dim=8,
                    disc_num_rep=4, disc_filter_sizes=(2, 3),
                    disc_num_filters=(10, 12))
    batch = tsteps.batch_to(make_batch([np.arange(4, 9)] * 6, None,
                                       config.seq_len), device)
    g = torch.Generator(device=device).manual_seed(4)
    noise = {"uniforms": torch.rand((config.seq_len, 6, 300), generator=g,
                                    device=device),
             "keep": [torch.rand((24, 22), generator=g, device=device) < 0.8
                      for _ in range(3)]}
    return config, batch, noise


# launches per adversarial step: (sample_resid, sample, sample_embed,
# embed backward, chain, reverse)
ROUTE_LAUNCHES = {"kernel": (1, 0, 0, 0, 1, 0),
                  "kernel_rescore": (0, 1, 0, 0, 0, 2),
                  "kernel_embed": (0, 0, 1, 1, 1, 0),
                  "decoupled": (0, 0, 0, 0, 0, 2)}


@pytest.mark.parametrize("route", sorted(ROUTE_LAUNCHES))
def test_route_steps_match_the_kernel_route(device, route):
    config, batch, noise = _step_setup(device)
    fns = (decode_sample_resid, decode_sample_noise, decode_sample_embed,
           decode_sample_embed_bwd, lstm_bptt_chain, lstm_bptt_reverse)
    state = create_train_state(config, 0, device)
    with disc_conv.argmax_record() as rows:
        want = tsteps.adv_grads(config, state, batch, 4.0, noise)
    before = [f.launches for f in fns]
    with disc_conv.argmax_replay(rows):
        got = tsteps.adv_grads(config.replace(decode_impl=route), state,
                               batch, 4.0, noise)
    torch.cuda.synchronize()
    assert tuple(f.launches - b for f, b in zip(fns, before)) \
        == ROUTE_LAUNCHES[route]
    assert torch.equal(got[4]["gen_ids"], want[4]["gen_ids"])
    for a, c in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)
    for side in (2, 3):
        for k in want[side]:
            assert _rel(got[side][k], want[side][k]) <= 1e-4, k
