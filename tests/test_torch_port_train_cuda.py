"""The training kernels (``sample_resid`` decode, BPTT chain, disc conv
forward and backward) against their plain PyTorch versions, and the
training steps through them, on the card.  Every test skips without CUDA.
This file imports torch and the port only, so it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_train_cuda.py

Tolerances: ids and argmax rows exact; soft 1e-5, residuals and d_pre 1e-4
and gradients 1e-4 relative to their max (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample, decode_sample_noise, decode_sample_resid,
    decode_sample_resid_plain)
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_chain_plain)
from gan_image_captioning_tpu_torch.models import generator as tgen
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
# H % 4 != 0, one and three layers
@pytest.mark.parametrize("B,V,E,H,nl,T", [(1, 300, 48, 40, 2, 7),
                                          (33, 300, 48, 42, 3, 6),
                                          (5, 256, 32, 32, 1, 9)])
def test_sample_resid_matches_plain(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(B * 100 + nl)
    layers, w, b, emb = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    u = torch.rand((T, B, V), generator=torch.Generator(device=device)
                   .manual_seed(B), device=device)
    got = decode_sample_resid(feats, layers, w, b, emb, T, temperature=10.0,
                              uniforms=u)
    want = decode_sample_resid_plain(feats, layers, w, b, emb, T, u, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    for a, c in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)


def test_sample_resid_philox_is_seeded_and_uniform(device):
    rng = np.random.default_rng(0)
    V, E, H, T, B = 300, 16, 16, 5, 8
    layers, w, b, emb = _decoder(rng, V, E, H, 2, device)
    feats = _t(rng, device, B, E)
    u = torch.empty(T, B, V, device=device)
    a = decode_sample_resid(feats, layers, w, b, emb, T, seed=11,
                            uniforms_out=u)
    again = decode_sample_resid(feats, layers, w, b, emb, T, seed=11)
    other = decode_sample_resid(feats, layers, w, b, emb, T, seed=12)
    fed = decode_sample_resid(feats, layers, w, b, emb, T, uniforms=u)
    assert torch.equal(a[1], again[1]) and not torch.equal(a[1], other[1])
    assert torch.equal(a[0], fed[0])
    torch.testing.assert_close(a[1], fed[1], atol=0, rtol=0)
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def test_sample_resid_ties_take_the_first_index(device):
    rng = np.random.default_rng(1)
    V, E, H, T = 300, 16, 16, 3
    layers, _, _, emb = _decoder(rng, V, E, H, 1, device)
    w = torch.zeros(V, H, device=device)
    b = torch.zeros(V, device=device)
    b[[5, 200, 299]] = 2.0          # tie across tiles 0, 3 and 4
    feats = torch.zeros(1, E, device=device)
    u = torch.full((T, 1, V), 0.5, device=device)
    ids, soft, *_ = decode_sample_resid(feats, layers, w, b, emb, T,
                                        temperature=3.0, uniforms=u)
    assert ids.tolist() == [[5] * T]
    torch.testing.assert_close(soft.sum(dim=2), torch.ones(T, 1, device=device))


@pytest.mark.parametrize("nl,H", [(1, 20), (2, 16), (3, 20)])
def test_bptt_chain_matches_plain(device, nl, H):
    rng = np.random.default_rng(nl)
    T, B = 5, 33
    w_hhs = _t(rng, device, nl, H, 4 * H, scale=0.3)
    w_ihs = _t(rng, device, max(nl - 1, 1), H, 4 * H, scale=0.3)
    args = (w_hhs, w_ihs, _t(rng, device, T, B, H),
            _t(rng, device, T, nl, B, 4 * H), _t(rng, device, T, nl, B, H))
    got = lstm_bptt_chain(*args)
    want = lstm_bptt_chain_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-4


def _conv_setup(device, eds, ties=False, B=3, R=6, L=9, banks=((70, 2),
                                                               (33, 4))):
    rng = np.random.default_rng(eds)
    maxf = max(f for _, f in banks)
    emb = _t(rng, device, B, L, R * eds)
    if ties:
        emb[:] = emb[:, :1].clone()
    convs = [(_t(rng, device, n, 1, f, eds, scale=0.5),
              _t(rng, device, n, scale=0.1)) for n, f in banks]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, eds)
    emb_pad = torch.nn.functional.pad(emb, (0, 0, 0, maxf - 1)).contiguous()
    return emb_pad, w_all.contiguous(), b_all.contiguous(), banks, R


# besides the first three: banks of n off the 64-filter tile, 2-5 taps at
# eds 2 and 3 (4-15 taps a filter: in registers up to 8, past that in
# shared memory) and B*R off the 16-column tile
@pytest.mark.parametrize("eds,ties,shape", [
    (1, False, {}), (2, False, {}), (1, True, {}),
    (2, False, dict(B=5, R=7, L=11, banks=((65, 2), (130, 3), (5, 5)))),
    (3, False, dict(B=2, R=9, L=8, banks=((64, 3), (17, 5), (1, 2))))])
def test_conv_forward_and_backward_match_plain(device, eds, ties, shape):
    emb_pad, w_all, b_all, banks, R = _conv_setup(device, eds, ties,
                                                  **shape)
    before = disc_conv.conv_bank_forward.launches
    pooled, idxs = disc_conv.conv_bank_forward(emb_pad, w_all, b_all, banks,
                                               R, eds)
    pooled_p, idxs_p = disc_conv.conv_relu_maxpool_plain(
        emb_pad, w_all, b_all, banks, R, eds)
    torch.cuda.synchronize()
    # one launch per pass, every bank in it: the wrapper counts one call
    # and the plan holds one launch
    assert disc_conv.conv_bank_forward.launches - before == 1
    L = emb_pad.shape[1] - max(f for _, f in banks) + 1
    plan = disc_conv.conv_fwd_plan(emb_pad.shape[0] * R, L, eds, banks)
    assert len(plan["launches"]) == 1
    torch.testing.assert_close(pooled, pooled_p, atol=1e-5, rtol=0)
    off = 0
    for (n, _), i, ip in zip(banks, idxs, idxs_p):
        live = pooled_p[..., off:off + n] > 0
        assert torch.equal(i[live], ip[live])
        if ties:
            assert int(i.max()) == 0
        off += n
    g = torch.Generator(device=device).manual_seed(3)
    dpms, off = [], 0
    for n, _ in banks:
        dp = torch.randn(pooled[..., off:off + n].shape, generator=g,
                         device=device)
        dpms.append(torch.where(pooled[..., off:off + n] > 0, dp,
                                torch.zeros((), device=device)).contiguous())
        off += n
    d_emb, dw = disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds,
                                             idxs, dpms)
    d_emb_p, dw_p = disc_conv.conv_bwd_dx_plain(emb_pad, w_all, banks, R,
                                                eds, idxs, dpms)
    torch.cuda.synchronize()
    assert _rel(dw, dw_p) <= 1e-4 and _rel(d_emb, d_emb_p) <= 1e-5


def test_sample_soft_gradients_match_the_plain_route(device):
    config = Config(vocab_size=300, gen_embed_dim=24, gen_hidden_dim=20,
                    gen_num_layers=2, max_seq_len=5)
    gen = tgen.init_generator_params(torch.Generator().manual_seed(0),
                                     config, device, sweep=False)
    T, B = config.seq_len, 6
    u = torch.rand((T, B, 300), generator=torch.Generator(device=device)
                   .manual_seed(1), device=device)
    probe = torch.randn((B, T, 300), generator=torch.Generator(device=device)
                        .manual_seed(2), device=device)
    grads = []
    for plain in (False, True):
        gen.zero_grad()
        feats = tgen.start_token_features(gen.decoder, B)
        soft, _ = tgen.sample_soft(gen.decoder, feats, T, 4.0, uniforms=u,
                                   plain=plain)
        (soft * probe).sum().backward()
        grads.append({k: p.grad.clone() for k, p in gen.named_parameters()})
    for k in grads[1]:
        assert _rel(grads[0][k], grads[1][k]) <= 1e-4, k


def test_steps_launch_the_kernels(device):
    config = Config(vocab_size=300, gen_embed_dim=24, gen_hidden_dim=20,
                    gen_num_layers=2, max_seq_len=5, disc_embed_dim=8,
                    disc_num_rep=4, disc_filter_sizes=(2, 3),
                    disc_num_filters=(10, 12), disc_train_freq=2)
    state = create_train_state(config, 0, device)
    batch = tsteps.batch_to(make_batch([np.arange(4, 9)] * 6, None,
                                       config.seq_len), device)
    fns = (decode_sample, decode_sample_resid, lstm_bptt_chain,
           disc_conv.conv_bank_forward, disc_conv.conv_bank_backward)
    before = [f.launches for f in fns]
    state, m = tsteps.make_mle_step(config)(state, batch)
    assert np.isfinite(float(m["gen_pretrain_loss"]))
    for _ in range(2):
        state, m = tsteps.make_adv_step(config)(state, batch, 5.0)
        assert all(np.isfinite(float(v)) for v in m.values())
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 2, 2, 6, 6]
    assert (state.gen_steps, state.disc_steps) == (2, 1)


def test_wrappers_raise_rather_than_fall_back(device):
    rng = np.random.default_rng(2)
    layers, w, b, emb = _decoder(rng, 64, 8, 8, 1, device)
    feats = _t(rng, device, 2, 8)
    before = decode_sample_resid.launches, decode_sample_noise.launches
    with pytest.raises(TypeError):
        decode_sample_resid(feats.half(), layers, w, b, emb, 3)
    with pytest.raises(ValueError):   # uniforms one column short
        decode_sample(feats, layers, w, b, emb, 3, mode="sample",
                      uniforms=torch.zeros(3, 2, 63, device=device))
    assert (decode_sample_resid.launches,
            decode_sample_noise.launches) == before
    emb_pad, w_all, b_all, banks, R = _conv_setup(device, 1)
    with pytest.raises(TypeError):
        disc_conv.conv_bank_forward(emb_pad.half(), w_all, b_all, banks,
                                    R, 1)
    args = [t.to(device) for t in (torch.zeros(1, 4, 16), torch.zeros(
        1, 4, 16), torch.zeros(3, 2, 4), torch.zeros(3, 1, 2, 16),
        torch.zeros(3, 1, 2, 4))]
    with pytest.raises(TypeError):
        lstm_bptt_chain(args[0], args[1], args[2].half(), args[3],
                        args[4])


def test_eval_greedy_launches_the_decode_kernel(device):
    """``eval/decode.greedy`` on CUDA tensors goes through the decode
    kernel (it ran the plain Python loop before the training slice)."""
    from gan_image_captioning_tpu_torch.eval.decode import greedy
    from gan_image_captioning_tpu_torch.kernels.decode_sample import (
        decode_sample_plain)

    config = Config(vocab_size=300, gen_embed_dim=24, gen_hidden_dim=20,
                    gen_num_layers=2, max_seq_len=5)
    gen = tgen.init_generator_params(torch.Generator().manual_seed(0),
                                     config, device, sweep=False)
    dec = gen.decoder
    feats = tgen.start_token_features(dec, 3).detach()
    before = decode_sample.launches
    ids = greedy(gen, feats, config)
    assert decode_sample.launches == before + 1
    want, _ = decode_sample_plain(feats, dec.lstm.layers(), dec.linear.weight,
                                  dec.linear.bias, dec.embed.weight,
                                  config.seq_len)
    assert torch.equal(ids, want)
