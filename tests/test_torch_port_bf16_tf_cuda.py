"""The bfloat16 instantiations of the flash-attention kernels (the fused
forward and backward up to D = 64, the tiled forward and backward) and of the fused
Gumbel sampler on the card (``--dtype bfloat16``), and config4-shaped
steps through them.  Every test skips without CUDA.  This file imports
torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_bf16_tf_cuda.py

Checked: against the plain versions (``flash_fwd_plain``,
``flash_bwd_plain``, ``gumbel_sample_plain``) on the same bfloat16
inputs, each bfloat16 output entry equal or one bfloat16 step apart (2^-7
of its magnitude: both round float32 values that differ by a float32 sum
order), plus 1e-5 of the tensor's largest entry where a sum cancels (the
float32 kernels' tolerance); lse within 1e-5; ids equal except where the
top two ``x`` are within 1e-5.  Against the float32 instantiation on the
widened inputs (the same plan, the same sums): out, dq, dk,
dv and soft equal to its outputs rounded once, lse and ids equal.  A
bfloat16 call counts one launch on ``launches`` and on ``bf16_launches``;
a tensor of another dtype than q's raises TypeError and launches
nothing."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.data.loader import make_batch
from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs
from gan_image_captioning_tpu_torch.train import steps as tsteps
from gan_image_captioning_tpu_torch.train.state import create_train_state

BF = torch.bfloat16
STEP, FLOOR, TIE_GAP = 2.0 ** -7, 1e-5, 1e-5
# (B, T, H, D): config4's generator, discriminator and rollouts, ragged
# T, the column-half kernels (32 < D <= 64) at T = 1, 37 and 64 with
# config5's [64, 37, 12, 64], and the tiled kernels past the fused ones'
# T or D
SHAPES = [(64, 37, 8, 32), (64, 36, 8, 16), (256, 36, 8, 16), (2, 35, 2, 8),
          (2, 200, 2, 24), (1, 70, 1, 256),
          (2, 1, 3, 40), (4, 37, 3, 40), (2, 64, 2, 40), (2, 1, 2, 48),
          (4, 37, 4, 48), (2, 64, 3, 48), (2, 1, 12, 64), (64, 37, 12, 64),
          (2, 64, 3, 64), (2, 37, 2, 72),
          # the long captions of --max-seq-len 126 (the tiled backward)
          (64, 129, 8, 32), (64, 128, 8, 16), (256, 128, 8, 16),
          (64, 129, 12, 64)]
MASKS = [(True, True), (True, False), (False, False), (False, True)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(device, BF)


def _steps_apart(got, want, what, scale=None):
    """Each entry within a bfloat16 step, plus FLOOR of ``scale`` (the
    tensor's largest entry unless given)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if scale is None else scale
    tol = STEP * torch.maximum(got.abs(), want.abs()) + FLOOR * scale
    assert bool(((got - want).abs() <= tol).all()), (
        what, float((got - want).abs().max()))


def _launches():
    return {n: (f.launches, f.bf16_launches) for n, f in (
        ("fwd", fa.flash_fwd), ("bwd", fa.flash_bwd),
        ("gumbel", gs.gumbel_sample))}


def _launched(before):
    return {k: (a - before[k][0], b - before[k][1])
            for k, (a, b) in _launches().items()
            if (a, b) != before[k]}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_bf16_matches_plain_and_float32(device, shape, causal,
                                              with_lengths):
    b, t = shape[:2]
    q, k, v, g = (_bf(shape, i, device) for i in range(4))
    lens = None
    if with_lengths:
        lens = torch.from_numpy(np.random.default_rng(9).integers(
            1, t + 1, b).astype(np.int32)).to(device)
    before = _launches()
    out, lse = fa.flash_fwd(q, k, v, causal, lens)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, g, lse, causal, lens)
    torch.cuda.synchronize()
    # one bfloat16 launch each way, on the route the plan names
    assert _launched(before) == {"fwd": (1, 1), "bwd": (1, 1)}
    assert fa.flash_bwd.last_kernel == fa.flash_bwd_plan(
        t, shape[2], shape[3])["route"]
    assert all(x.dtype == BF for x in (out, dq, dk, dv))
    assert lse.dtype == torch.float32
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal, lens)
    _steps_apart(out, p_out, "out")
    torch.testing.assert_close(lse, p_lse, atol=1e-5, rtol=1e-5)
    refs = fa.flash_bwd_plain(q, k, v, out, g, lse, causal, lens)
    top = max(float(r.float().abs().max()) for r in refs)
    for name, a, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        # at T = 1 dq and dk are zero in exact arithmetic (one key, a
        # constant softmax): both sides hold the rounding of dO.v - delta,
        # held to the largest gradient's scale
        _steps_apart(a, ref, name, top if t == 1 and name != "dv" else None)
    # the float32 instantiation on the widened inputs, rounded once
    f_out, f_lse = fa.flash_fwd(q.float(), k.float(), v.float(), causal,
                                lens)
    assert torch.equal(out, f_out.to(BF)) and torch.equal(lse, f_lse)
    for a, f in zip((dq, dk, dv), fa.flash_bwd(
            q.float(), k.float(), v.float(), out.float(), g.float(), lse,
            causal, lens)):
        assert torch.equal(a, f.to(BF))


@pytest.mark.parametrize("shape,causal", [((4, 36, 8, 16), False),
                                          ((4, 37, 12, 64), False),
                                          ((4, 37, 12, 64), True),
                                          ((4, 37, 2, 72), True)])
def test_flash_bf16_autograd_and_row_of_length_zero(device, shape, causal):
    q, k, v = (_bf(shape, i, device).requires_grad_(True) for i in range(3))
    t = shape[1]
    lens = torch.tensor([0, t, 5, t], dtype=torch.int32, device=device)
    out = fa.flash_attention(q, k, v, causal, lens)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert float(out[0].float().abs().max()) == 0.0
    assert all(float(gr[0].float().abs().max()) == 0.0 for gr in grads)
    assert all(bool(torch.isfinite(gr.float()).all()) for gr in grads)
    assert all(gr.dtype == BF for gr in grads)


def test_flash_bf16_refuses_mixed_dtypes(device):
    q = _bf((2, 9, 2, 8), 0, device)
    before = _launches()
    with pytest.raises(TypeError):
        fa.flash_fwd(q, q.float(), q, True)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half(), True)
    out, lse = fa.flash_fwd(q, q, q, True)
    with pytest.raises(TypeError):
        fa.flash_bwd(q, q, q, out, out.float(), lse, True)
    assert _launched(before) == {"fwd": (1, 1)}


GUMBEL_SHAPES = [(64, 11008), (64, 11007), (1, 11008), (256, 11008),
                 (4096, 16), (3, 50257), (5, 257)]


@pytest.mark.parametrize("B,V", GUMBEL_SHAPES)
def test_gumbel_bf16_matches_plain_and_float32(device, B, V):
    logits = _bf((B, V), V, device, 3.0)
    u = torch.rand((B, V), generator=torch.Generator(device=device)
                   .manual_seed(V), device=device)
    before = _launches()
    soft, ids = gs.gumbel_sample(logits, 2.0, uniforms=u)
    torch.cuda.synchronize()
    assert _launched(before) == {"gumbel": (1, 1)}
    assert soft.dtype == BF
    p_soft, p_ids = gs.gumbel_sample_plain(logits, 2.0, u)
    _steps_apart(soft, p_soft, "soft")
    x = (logits.float() - torch.log(-torch.log(u + gs.EPS) + gs.EPS)) * 2.0
    top = x.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) <= TIE_GAP
    assert bool(((ids == p_ids) | near).all())
    f_soft, f_ids = gs.gumbel_sample(logits.float(), 2.0, uniforms=u)
    assert torch.equal(ids, f_ids) and torch.equal(soft, f_soft.to(BF))
    # the Philox draw: the float32 instantiation's uniforms and ids
    u_a, u_b = torch.empty_like(u), torch.empty_like(u)
    s_a, i_a = gs.gumbel_sample(logits, 2.0, seed=5, step=3, uniforms_out=u_a)
    s_b, i_b = gs.gumbel_sample(logits.float(), 2.0, seed=5, step=3,
                                uniforms_out=u_b)
    assert torch.equal(u_a, u_b) and torch.equal(i_a, i_b)
    assert torch.equal(s_a, s_b.to(BF))


def test_gumbel_bf16_backward_and_dtypes(device):
    logits = _bf((3, 50), 1, device).requires_grad_(True)
    u = torch.rand((3, 50), device=device)
    soft, _ = gs.fused_gumbel_sample(logits, 0, 2.5, uniforms=u)
    d = _bf((3, 50), 2, device)
    got, = torch.autograd.grad(soft, logits, d)
    s32, d32 = soft.float(), d.float()
    want = (2.5 * s32 * (d32 - (d32 * s32).sum(-1, keepdim=True))).to(BF)
    assert got.dtype == BF and torch.equal(got, want)
    before = _launches()
    with pytest.raises(TypeError):
        gs.gumbel_sample(logits.detach().half(), 1.0)
    with pytest.raises(TypeError):
        gs.gumbel_sample(logits.detach(), 1.0, uniforms=u.to(BF))
    assert _launched(before) == {}


KW = dict(vocab_size=64, gen_arch="transformer", disc_arch="transformer",
          gen_embed_dim=32, gen_hidden_dim=32, gen_num_layers=2,
          gen_num_heads=4, disc_embed_dim=16, disc_hidden_dim=32,
          disc_num_heads=4, disc_num_layers=2, max_seq_len=6,
          rollout_num=2, rollout_stride=3, dtype="bfloat16")


@pytest.mark.parametrize("objective", ["reinforce", "gumbel"])
def test_bf16_steps_launch_only_bf16_kernels(device, objective):
    config = Config(**KW, adv_objective=objective)
    B, T = 4, config.seq_len
    rng = np.random.default_rng(0)
    caps = [rng.integers(4, 64, size=rng.integers(1, 6)) for _ in range(B)]
    batch = tsteps.batch_to(make_batch(caps, None, T), device)
    state = create_train_state(config, 0, device, sweep=False)
    before = _launches()
    state, m1 = tsteps.make_mle_step(config)(state, batch)
    state, m2 = tsteps.make_adv_step(config)(state, batch, 2.0)
    torch.cuda.synchronize()
    launched = _launched(before)
    assert launched and all(a == b > 0 for a, b in launched.values())
    assert {"fwd", "bwd", "gumbel"} <= set(launched)
    assert all(np.isfinite(float(v)) for m in (m1, m2) for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
