"""The kernels' bfloat16 instantiations (``--dtype bfloat16``) against
their plain PyTorch versions on the card, in bfloat16: the decode modes
``sample_resid``, ``pretrain`` and ``greedy`` (resident and streamed
weights, aligned and unaligned rows), the quantized serve at int8 and
int4 (full and carried), the BPTT chain and reverse, the ``mxu`` conv
forward and backward, ``image_norm``; a bfloat16 call counts one launch,
on both the wrapper's ``launches`` and its ``bf16_launches``, and every wrapper raises on a dtype it has no instantiation for (float16)
and launches nothing.  Every test skips without CUDA.  This file imports
torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_bf16_cuda.py

Tolerances: a bfloat16 output of the same bfloat16 inputs (the soft
sample from the kernel's own top h, the pooled conv features) within one
bfloat16 step of each entry (kernel and plain version round float32
values that differ by a float32 sum order); in bfloat16 units (2^-8 of
the largest entry), a bfloat16 carry (h, c, gates) against the plain
decode fed the kernel's ids 2 units (a rounding that tipped at one step
moves the later ones by about a unit); a float32
log-probability from bfloat16 carries 2 units of the largest (a rounding
of h that tips the other way moves it about one unit); ids equal, or the
kernel's id a tie, within 4 units of the largest |score| of the plain
version's max score when the plain version is fed the kernel's ids (two
scores, each 2 units off at most); float32 results of bfloat16
inputs (the BPTT kernels, the conv backward) as their float32
instantiations are held: 1e-4 of the largest entry (d_pre, dW), 1e-5
times the larger of 1 and the largest (dX, db)."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.kernels import image_norm as inorm
from gan_image_captioning_tpu_torch.kernels.lstm_bptt import (
    lstm_bptt_chain, lstm_bptt_chain_plain, lstm_bptt_reverse,
    lstm_bptt_reverse_plain)
from gan_image_captioning_tpu_torch.models.generator import (
    init_generator_params)
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise
from gan_image_captioning_tpu_torch.ops.quantize import quantize_lstm_decoder

BF = torch.bfloat16
UNIT = 2.0 ** -8


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, device, *shape, scale=1.0, dtype=BF):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(device, dtype)


def _decoder(rng, V, E, H, nl, device):
    k = 1.0 / np.sqrt(H)
    layers = [{"w_ih": _t(rng, device, 4 * H, E if l == 0 else H, scale=k),
               "w_hh": _t(rng, device, 4 * H, H, scale=k),
               "b_ih": _t(rng, device, 4 * H, scale=k),
               "b_hh": _t(rng, device, 4 * H, scale=k)} for l in range(nl)]
    return (layers, _t(rng, device, V, H, scale=k),
            _t(rng, device, V, scale=0.1), _t(rng, device, V, E))


def _close(a, b, units, what):
    a, b = a.float(), b.float()
    tol = units * UNIT * float(b.abs().max())
    assert float((a - b).abs().max()) <= tol, what


def _steps(a, b, what):
    """Each entry equal or one bfloat16 step apart (a step of a normal x
    is at most 2^-7 |x|)."""
    a, b = a.float(), b.float()
    bound = 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= bound
                 + torch.finfo(torch.float32).tiny).all()), what


def _counts(fn):
    return fn.launches, fn.bf16_launches


def _plus_one(before, fn):
    return _counts(fn) == (before[0] + 1, before[1] + 1)


def _forced(weights, feats, ids, u=None, temp=1.0):
    """The plain bfloat16 decode fed the given ids → float32 scores,
    bfloat16 soft sample and residuals, float32 log-probabilities."""
    layers, w_proj, b_proj, embed = weights
    h, c = ds._zero_state(feats, layers)
    x, out = feats, {k: [] for k in ("scores", "soft", "hs", "cs", "gates",
                                     "lps")}
    for t in range(ids.shape[1]):
        gates = ds._stack_step(layers, x, h, c)
        logits = ds._logits(h[-1], w_proj, b_proj)
        s = logits if u is None else logits + gumbel_noise(u[t].shape,
                                                           u=u[t])
        idt = ids[:, t].long()
        out["scores"].append(s)
        out["soft"].append(torch.softmax(s * temp, dim=-1).to(BF))
        out["hs"].append(torch.stack(h))
        out["cs"].append(torch.stack(c).to(BF))
        out["gates"].append(torch.stack(gates).to(BF))
        out["lps"].append(torch.log_softmax(logits, -1).gather(
            1, idt[:, None])[:, 0])
        x = embed[idt]
    return {k: torch.stack(v) for k, v in out.items()}


def _assert_ties(scores_tm, ids):
    """Each id the plain version's max score or a tie: within 4 units of
    the largest |score| (each of the two scores may sit 2 units off)."""
    chosen = scores_tm.gather(2, ids.T.long()[..., None])[..., 0]
    gap = float((scores_tm.max(dim=2).values - chosen).max())
    assert gap <= 4 * UNIT * float(scores_tm.abs().max())


# an unaligned E (30: the features and w_ih rows take element loads), H %
# 4 != 0, a vocabulary tile edge, one and three layers, and H = 1024 x 2
# layers, whose gate rows do not fit in shared memory (the streamed branch:
# bfloat16 rows staged and widened every step)
SHAPES = [(1, 300, 48, 40, 2, 7), (33, 130, 30, 20, 1, 5),
          (8, 256, 64, 64, 3, 4), (4, 512, 256, 1024, 2, 3)]


@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_sample_resid_bf16_matches_plain(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(B + V)
    weights = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    u = torch.from_numpy(rng.random((T, B, V), dtype=np.float32)).to(device)
    before = _counts(ds.decode_sample_resid)
    ids, soft, hs, cs, gates = ds.decode_sample_resid(
        feats, *weights, T, temperature=1.5, uniforms=u)
    assert _plus_one(before, ds.decode_sample_resid)
    assert all(x.dtype == BF for x in (soft, hs, cs, gates))
    ref = _forced(weights, feats, ids, u, 1.5)
    _assert_ties(ref["scores"], ids)
    for name, got in (("hs", hs), ("cs", cs), ("gates", gates)):
        _close(got, ref[name], 2, name)
    s = ds._logits(hs[:, -1], weights[1], weights[2]) + gumbel_noise(
        u.shape, u=u)
    _steps(soft, torch.softmax(s * 1.5, dim=-1).to(BF), "soft")
    if H == 1024:
        assert ds.last_plan["resident"] is False


@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_pretrain_and_greedy_bf16_match_plain(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(3 * B + V)
    weights = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    before = _counts(ds.decode_sample_logits), _counts(ds.decode_sample)
    ids, logits = ds.decode_sample(feats, *weights, T, mode="pretrain")
    ids_g = ds.decode_sample(feats, *weights, T, mode="greedy")
    assert _plus_one(before[0], ds.decode_sample_logits)
    assert _plus_one(before[1], ds.decode_sample)
    assert logits.dtype == BF and torch.equal(ids, ids_g)
    ref = _forced(weights, feats, ids)
    _assert_ties(ref["scores"], ids)
    _close(logits, ref["scores"], 2, "logits")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_qserve_bf16_matches_plain(device, bits, B):
    rng = np.random.default_rng(bits + B)
    V, E, H, T = 512, 64, 64, 6
    config = Config(vocab_size=V, gen_embed_dim=E, gen_hidden_dim=H,
                    gen_num_layers=2)
    gen = init_generator_params(torch.Generator().manual_seed(bits + B),
                                config, device, sweep=False)
    qdec = quantize_lstm_decoder(gen.decoder, bits)
    feats = _t(rng, device, B, E)
    before = _counts(ds.decode_sample_q_serve)
    ids, lps = ds.decode_sample_q_serve(feats, qdec, T, bits=bits)
    assert _plus_one(before, ds.decode_sample_q_serve)
    assert lps.dtype == torch.float32
    ref = _forced(ds.dequantized_decoder(qdec, bits, BF), feats, ids)
    _assert_ties(ref["scores"], ids)
    _close(lps, ref["lps"].T, 2, "lps")
    # carried chunks (h and x bfloat16, c float32) equal the full decode
    h = torch.zeros(2, B, H, device=device, dtype=BF)
    c = torch.zeros(2, B, H, device=device)
    x, parts = feats, []
    for k in (4, 2):
        i, lp, (h, c, x) = ds.decode_sample_q_serve(
            x, qdec, k, init_state=(h, c, x), bits=bits)
        assert (h.dtype, c.dtype, x.dtype) == (BF, torch.float32, BF)
        parts.append((i, lp))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), ids)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), lps)


@pytest.mark.parametrize("B,H,NL,T", [(64, 512, 2, 36), (5, 24, 3, 4)])
def test_chain_bf16_matches_plain(device, B, H, NL, T):
    rng = np.random.default_rng(B + H)
    w_hhs = _t(rng, device, NL, H, 4 * H, scale=H ** -0.5,
               dtype=torch.float32)
    w_ihs = _t(rng, device, max(NL - 1, 1), H, 4 * H, scale=H ** -0.5,
               dtype=torch.float32)
    d_hs = _t(rng, device, T, B, H, scale=1e-2, dtype=torch.float32)
    gates, cs = _t(rng, device, T, NL, B, 4 * H), _t(rng, device, T, NL, B, H)
    before = _counts(lstm_bptt_chain)
    got = lstm_bptt_chain(w_hhs, w_ihs, d_hs, gates, cs)
    assert _plus_one(before, lstm_bptt_chain)
    want = lstm_bptt_chain_plain(w_hhs, w_ihs, d_hs, gates, cs)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("B,H,T", [(64, 512, 36), (3, 20, 5),
                                   (4, 1024, 3)])
def test_reverse_bf16_matches_plain(device, B, H, T):
    rng = np.random.default_rng(B * H)
    args = (_t(rng, device, H, 4 * H, scale=H ** -0.5),
            _t(rng, device, T, B, H, scale=1e-2),
            _t(rng, device, T, B, 4 * H), _t(rng, device, T, B, H),
            _t(rng, device, T, B, H))
    before = _counts(lstm_bptt_reverse)
    got = lstm_bptt_reverse(*args)
    assert _plus_one(before, lstm_bptt_reverse)
    for a, b in zip(got, lstm_bptt_reverse_plain(*args)):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-30)


def _conv(device, rng, B=8, R=4, T=12):
    banks = ((40, 3), (70, 4), (30, 5))
    maxf = max(f for _, f in banks)
    emb = torch.nn.functional.pad(_t(rng, device, B, T, R), (0, 0, 0,
                                                             maxf - 1))
    w_all = _t(rng, device, sum(n for n, _ in banks), maxf, scale=0.5)
    return emb.contiguous(), w_all, _t(rng, device, w_all.shape[0],
                                       scale=0.1), banks, R


def test_conv_forward_and_backward_bf16_match_plain(device):
    rng = np.random.default_rng(7)
    emb, w_all, b_all, banks, R = _conv(device, rng)
    before = (_counts(disc_conv.conv_bank_forward),
              _counts(disc_conv.conv_bank_backward))
    pooled, idx = disc_conv.conv_bank_forward(emb, w_all, b_all, banks, R, 1)
    pooled_p, idx_p = disc_conv.conv_relu_maxpool_plain(emb, w_all, b_all,
                                                        banks, R, 1)
    assert pooled.dtype == BF
    _steps(pooled, pooled_p, "pooled")
    assert all(torch.equal(a, b) for a, b in zip(idx, idx_p))
    d_pooled = _t(rng, device, *pooled.shape)
    got = disc_conv.conv_bank_backward_raw(emb, w_all, banks, R, 1, pooled,
                                           idx, d_pooled)
    want = disc_conv.conv_rows_backward_plain(emb, w_all, banks, R, 1,
                                              pooled, idx, d_pooled)
    assert _plus_one(before[0], disc_conv.conv_bank_forward)
    assert _plus_one(before[1], disc_conv.conv_bank_backward)
    for name, a, b, tol in (("dx", got[0], want[0], 1e-5),
                            ("dw", got[1], want[1], 1e-4),
                            ("db", got[2], want[2], 1e-5)):
        assert a.dtype == torch.float32, name
        assert float((a - b).abs().max()) <= tol * max(
            1.0, float(b.abs().max())), name


def test_conv_autograd_rounds_gradients_to_bf16(device):
    """Through the ``mxu`` autograd route the gradients come back in the
    inputs' dtype, bfloat16 (the JAX ``_mxu_vjp_bwd`` casts them)."""
    rng = np.random.default_rng(8)
    emb, w_all, b_all, banks, R = _conv(device, rng)
    leaves = [t.clone().requires_grad_(True) for t in (emb, w_all, b_all)]
    out = disc_conv.conv_relu_maxpool(*leaves, banks, R, 1, engine="mxu")
    out.float().sum().backward()
    assert all(t.grad.dtype == BF for t in leaves)


@pytest.mark.parametrize("shape,offset", [((64, 3, 256, 256), 0),
                                          ((3, 3, 37, 37), 0),
                                          ((3, 3, 37, 37), 1)])
def test_image_norm_bf16_is_bit_equal(device, shape, offset):
    rng = np.random.default_rng(9)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 256, n + offset,
                                         dtype=np.uint8)).to(device)
    u8 = flat[offset:].view(shape)
    before = _counts(inorm.normalize_images)
    got = inorm.normalize_images(u8, BF)
    assert _plus_one(before, inorm.normalize_images)
    assert got.dtype == BF
    assert torch.equal(got, inorm.normalize_images_plain(u8, BF))


def test_wrappers_raise_on_float16_and_launch_nothing(device):
    rng = np.random.default_rng(10)
    layers, w, b, emb = _decoder(rng, 64, 8, 8, 1, device)
    half = ([{k: v.half() for k, v in lp.items()} for lp in layers],
            w.half(), b.half(), emb.half())
    feats = _t(rng, device, 2, 8, dtype=torch.float16)
    counters = [ds.decode_sample, ds.decode_sample_resid,
                ds.decode_sample_logits, ds.decode_sample_noise,
                ds.decode_sample_embed, ds.decode_sample_embed_bwd,
                ds.decode_sample_q_serve, lstm_bptt_chain,
                lstm_bptt_reverse, disc_conv.conv_bank_forward,
                disc_conv.conv_bank_backward, disc_conv.conv_bank_dxs,
                inorm.normalize_images]
    before = [f.launches for f in counters]
    for mode in ("greedy", "serve", "pretrain", "sample_resid", "sample"):
        with pytest.raises(TypeError):
            ds.decode_sample(feats, *half, 3, mode=mode)
    # every mode has a bfloat16 instantiation now; float16 is refused by
    # the sample_embed decode and its backward too
    with pytest.raises(TypeError):
        ds.decode_sample(feats, *half, 3, mode="sample_embed",
                         disc_embed=torch.zeros(4, 64, device=device,
                                                dtype=torch.float16))
    with pytest.raises(TypeError):
        ds.decode_sample_embed_bwd(*(
            torch.zeros(s, device=device, dtype=torch.float16)
            for s in ((3, 2, 8), (3, 2, 64), (3, 2, 4), (64, 8), (4, 64))),
            1.0)
    with pytest.raises(TypeError):
        lstm_bptt_chain(*(torch.zeros(s, device=device, dtype=torch.float16)
                          for s in ((1, 4, 16), (1, 4, 16), (3, 2, 4),
                                    (3, 1, 2, 16), (3, 1, 2, 4))))
    with pytest.raises(TypeError):
        lstm_bptt_reverse(*(torch.zeros(s, device=device, dtype=torch.float16)
                            for s in ((4, 16), (3, 2, 4), (3, 2, 16),
                                      (3, 2, 4), (3, 2, 4))))
    emb16, w16, b16, banks, R = (t.half() if torch.is_tensor(t) else t
                                 for t in _conv(device, rng))
    with pytest.raises(TypeError):
        disc_conv.conv_bank_forward(emb16, w16, b16, banks, R, 1)
    pooled16 = torch.zeros(emb16.shape[0], R, w16.shape[0], device=device,
                           dtype=torch.float16)
    idx = [torch.zeros(emb16.shape[0], R, n, device=device,
                       dtype=torch.int32) for n, _ in banks]
    with pytest.raises(TypeError):
        disc_conv.conv_bank_dxs_raw(emb16, w16, banks, R, 1, pooled16, idx,
                                    pooled16)
    with pytest.raises(TypeError):
        inorm.normalize_images(torch.zeros(1, 3, 4, 4, dtype=torch.uint8,
                                           device=device), torch.float16)
    assert [f.launches for f in counters] == before
