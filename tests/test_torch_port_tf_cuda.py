"""The flash-attention kernels (forward, dQ, dK/dV) and the fused Gumbel
sampler against their plain versions on the card, and the transformer
GAN's steps through them.  Every test skips without CUDA.  This file
imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tf_cuda.py

Tolerances: flash outputs within 2e-6 of the dense plain version and
gradients within 1e-5 of the largest gradient (float32 sums in another
order; unit-scale inputs); the sampler's soft rows within 1e-6 and its ids
equal except where the top two ``x`` are within 1e-5; the Philox draw's
histogram of ids within 0.01 of ``softmax(logits)`` over 2^16 rows.
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs
from gan_image_captioning_tpu_torch.kernels.decode_sample import (
    decode_sample_resid)
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

OUT_ATOL, GRAD_RTOL, SOFT_ATOL, TIE_GAP = 2e-6, 1e-5, 1e-6, 1e-5
# (B, T, H, D): the generator's and the discriminator's shapes, ragged
# lengths, a head dim whose row needs a non-power-of-two thread count, the
# largest head dim
SHAPES = [(4, 37, 8, 32), (4, 36, 8, 16), (2, 35, 2, 8), (2, 200, 2, 24),
          (1, 70, 1, 256)]
MASKS = [(True, True), (True, False), (False, False), (False, True)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(shape, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device).requires_grad_(True) for _ in range(3)]


def _lengths(b, t, causal, seed, device):
    rng = np.random.default_rng(seed)
    # causal with lengths: the MLE pass's lengths + 1 (never 0)
    return torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(
        device)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_matches_plain(device, shape, causal, with_lengths):
    q, k, v = _qkv(shape, sum(shape), device)
    lens = (_lengths(shape[0], shape[1], causal, 3, device) if with_lengths
            else None)
    counts = [f.launches for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)]
    out = fa.flash_attention(q, k, v, causal, lens)
    g = torch.randn(out.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)] \
        == [c + 1 for c in counts]
    ref = fa.attention_plain(q, k, v, causal, lens)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, atol=OUT_ATOL, rtol=0)
    for name, a, b in zip("qkv", grads, ref_grads):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= GRAD_RTOL, f"d{name}: {err}"


def test_flash_rows_past_length_get_no_key_gradient(device):
    q, k, v = _qkv((2, 37, 8, 32), 5, device)
    lens = torch.tensor([10, 37], dtype=torch.int32, device=device)
    out = fa.flash_attention(q, k, v, False, lens)
    dk, dv = torch.autograd.grad(out.sum(), (k, v))
    assert float(dk[0, 10:].abs().max()) == 0.0
    assert float(dv[0, 10:].abs().max()) == 0.0


def test_flash_malformed_calls_raise_and_launch_nothing(device):
    q, k, v = (x.detach() for x in _qkv((2, 9, 2, 8), 0, device))
    before = fa.flash_fwd.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :6], k[..., :6], v[..., :6], True)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double(), True)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k[:1], v, True)
    assert fa.flash_fwd.launches == before


def _top2_gap(x):
    top = x.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("B,V,temp", [(64, 11008, 1.0), (64, 11008, 10.0),
                                      (3, 1000, 100.0), (5, 257, 0.5)])
def test_gumbel_kernel_matches_plain_with_fed_uniforms(device, B, V, temp):
    rng = np.random.default_rng(V)
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(
        np.float32) * 3).to(device)
    u = torch.from_numpy(rng.random((B, V), dtype=np.float32)).to(device)
    before = gs.gumbel_sample.launches
    soft, ids = gs.gumbel_sample(logits, temp, uniforms=u)
    torch.cuda.synchronize()
    assert gs.gumbel_sample.launches == before + 1
    soft_p, ids_p = gs.gumbel_sample_plain(logits, temp, u)
    torch.testing.assert_close(soft, soft_p, atol=SOFT_ATOL, rtol=0)
    x = (logits - torch.log(-torch.log(u + gs.EPS) + gs.EPS)) * temp
    differ = ids != ids_p
    assert bool((_top2_gap(x)[differ] <= TIE_GAP * temp).all())
    assert ids.dtype == torch.int32


def test_gumbel_philox_is_reproducible_and_shared_with_sample_resid(device):
    B, V = 4, 300
    logits = torch.zeros((B, V), device=device)
    u_a = torch.empty((B, V), device=device)
    _, ids_a = gs.gumbel_sample(logits, 1.0, seed=77, step=3, uniforms_out=u_a)
    _, ids_b = gs.gumbel_sample(logits, 1.0, seed=77, step=3)
    _, ids_c = gs.gumbel_sample(logits, 1.0, seed=77, step=4)
    assert torch.equal(ids_a, ids_b) and not torch.equal(ids_a, ids_c)
    # the same (seed, step, row, column) uniforms as the LSTM decode's
    E, H = 8, 8
    gen = torch.Generator().manual_seed(0)
    layers = [{"w_ih": torch.randn(4 * H, E, generator=gen),
               "w_hh": torch.randn(4 * H, H, generator=gen),
               "b_ih": torch.zeros(4 * H), "b_hh": torch.zeros(4 * H)}]
    layers = [{k: t.to(device) for k, t in lp.items()} for lp in layers]
    u_resid = torch.empty((5, B, V), device=device)
    decode_sample_resid(torch.zeros((B, E), device=device), layers,
                        torch.zeros((V, H), device=device),
                        torch.zeros(V, device=device),
                        torch.zeros((V, E), device=device), 5, seed=77,
                        uniforms_out=u_resid)
    torch.cuda.synchronize()
    assert torch.equal(u_a, u_resid[3])


def test_gumbel_philox_ids_follow_softmax(device):
    V, N = 16, 1 << 16
    logits = torch.linspace(-2, 2, V, device=device)
    ids = gs.gumbel_sample(logits.expand(N, V).contiguous(), 1.0, seed=5)[1]
    hist = torch.bincount(ids.long(), minlength=V).double() / N
    want = torch.softmax(logits.double(), dim=0)
    assert float((hist - want).abs().max()) <= 0.01


def test_gumbel_backward_is_the_scaled_softmax_vjp(device):
    logits = torch.randn((3, 50), device=device, requires_grad=True)
    u = torch.rand((3, 50), device=device)
    soft, _ = gs.fused_gumbel_sample(logits, 0, 2.5, uniforms=u)
    d = torch.randn_like(soft)
    got, = torch.autograd.grad(soft, logits, d)
    ref = torch.softmax((logits + (-torch.log(-torch.log(u + gs.EPS)
                                              + gs.EPS))) * 2.5, dim=-1)
    want, = torch.autograd.grad(ref, logits, d)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_gumbel_malformed_calls_raise_and_launch_nothing(device):
    before = gs.gumbel_sample.launches
    x = torch.zeros((2, 5), device=device)
    with pytest.raises(ValueError):
        gs.gumbel_sample(x[0], 1.0)
    with pytest.raises(TypeError):
        gs.gumbel_sample(x.double(), 1.0)
    with pytest.raises(ValueError):
        gs.gumbel_sample(x, 1.0, uniforms=torch.zeros((2, 4), device=device))
    assert gs.gumbel_sample.launches == before


KW = dict(vocab_size=64, gen_arch="transformer", disc_arch="transformer",
          gen_embed_dim=32, gen_hidden_dim=32, gen_num_layers=2,
          gen_num_heads=4, disc_embed_dim=16, disc_hidden_dim=32,
          disc_num_heads=4, disc_num_layers=2, max_seq_len=6,
          adv_objective="reinforce", rollout_num=2, rollout_stride=3)


def _counts():
    return {"fwd": fa.flash_fwd.launches, "dq": fa.flash_dq.launches,
            "dkv": fa.flash_dkv.launches,
            "gumbel": gs.gumbel_sample.launches}


@pytest.mark.parametrize("objective", ["reinforce", "gumbel"])
def test_steps_launch_the_kernels_and_match_the_plain_route(device,
                                                             objective):
    config = Config(**KW).replace(adv_objective=objective)
    B, T = 4, config.seq_len
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, 64, size=rng.integers(1, 6)) for _ in range(B)]
    batch = tsteps.batch_to(make_batch(caps, None, T), device)
    state = create_train_state(config, 0, device, sweep=False)
    gen = torch.Generator(device=device).manual_seed(2)
    noise = {"uniforms": torch.rand((T, B, 64), generator=gen, device=device),
             "seed": 11}
    if objective == "gumbel":
        noise["keep"] = [torch.rand((B, 32), generator=gen, device=device)
                         < 0.8 for _ in range(3)]
    before = _counts()
    kern = tsteps.adv_grads(config, state, batch, 2.0, noise)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    plain = tsteps.adv_grads(config.replace(attn_impl="plain",
                                            decode_impl="plain"),
                             state, batch, 2.0, noise)
    assert torch.equal(kern[4]["gen_ids"], plain[4]["gen_ids"])
    for a, b in ((kern[0], plain[0]), (kern[1], plain[1])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    for side in (2, 3):
        scale = max(float(g.abs().max()) for g in plain[side].values())
        err = max(float((kern[side][k] - plain[side][k]).abs().max())
                  for k in plain[side])
        assert err <= 1e-4 * scale, (side, err, scale)
    nl = config.disc_num_layers
    if objective == "reinforce":
        # sample T Gumbel launches; flash forward: 2 training disc passes,
        # 2 rollout prefixes + the full score, the greedy baseline, the
        # log-prob pass; backward: the 2 training passes and the log-prob
        gl = config.gen_num_layers
        assert launched == {"gumbel": T, "fwd": nl * (2 + 2 + 1 + 1) + gl,
                            "dq": 2 * nl + gl, "dkv": 2 * nl + gl}
    else:
        assert launched == {"gumbel": T, "fwd": 3 * nl, "dq": 3 * nl,
                            "dkv": 3 * nl}
