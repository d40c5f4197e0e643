"""The kernels at preset config5's shapes on the card: the fused flash
kernels at GPT-2-small's head dim (D = 64: the column-half forward and the
one-launch backward) at the MLE pass's [64, 37, 12, 64], and the Gumbel
sampler at GPT-2's vocabulary with the 4 specials, [64, 50261] (the scalar
cluster path: V % 4 != 0, and the last CTA's slice runs past V).  Every
test skips without CUDA.  This file imports torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_config5_cuda.py

Checked against the plain versions on the same inputs, with the
tolerances of ``tests/test_torch_port_tf_cuda.py`` (float32: 2e-5 of the
largest entry; lse 1e-5) and ``tests/test_torch_port_bf16_tf_cuda.py``
(bfloat16: one bfloat16 step of each entry plus 1e-5 of the largest);
sampler ids equal except where the top two ``x`` are within 1e-5, and
ties across CTAs go to the lowest index, as ``torch.argmax`` and the
JAX argmax take them."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import flash_attention as fa
from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

BF = torch.bfloat16
STEP, FLOOR, TIE_GAP = 2.0 ** -7, 1e-5, 1e-5
SHAPE = (64, 37, 12, 64)
V5 = 50261


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _x(shape, seed, device, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(device, dtype)


def _close(got, want, dtype, what):
    got, want = got.float(), want.float()
    if dtype == BF:
        tol = (STEP * torch.maximum(got.abs(), want.abs())
               + FLOOR * float(want.abs().max()))
    else:
        tol = 2e-5 * float(want.abs().max()) + torch.zeros_like(want)
    assert bool(((got - want).abs() <= tol).all()), (
        what, float((got - want).abs().max()))


def test_gpt2_head_dim_takes_the_tiled_route():
    """GPT-2's head dim takes the tiled route only past T = 64: at the MLE
    pass's T = 37 both directions are fused, two heads a forward block and
    one a backward block."""
    t, h, d = SHAPE[1:]
    for plan, heads in ((fa.flash_fwd_plan, 2), (fa.flash_bwd_plan, 1)):
        assert plan(t, h, d)["route"] == "fused"
        assert plan(t, h, d)["heads"] == heads
        assert plan(65, h, d)["route"] == "tiled"
    assert not fa.supported(SHAPE[1], 65)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_flash_at_gpt2_shape_matches_plain(device, dtype, with_lengths):
    b, t = SHAPE[:2]
    q, k, v, g = (_x(SHAPE, i, device, dtype) for i in range(4))
    lens = None
    if with_lengths:
        # the MLE pass's lengths + 1, a row of one key and a full row
        lens = torch.from_numpy(np.random.default_rng(5).integers(
            1, t + 1, b).astype(np.int32))
        lens[0], lens[1] = 1, t
        lens = lens.to(device)
    counts = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    out, lse = fa.flash_fwd(q, k, v, True, lens)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, g, lse, True, lens)
    torch.cuda.synchronize()
    assert fa.flash_fwd.last_kernel == "fused"
    assert fa.flash_bwd.last_kernel == "fused"
    assert (fa.flash_fwd.launches - counts[0],
            fa.flash_bwd.launches - counts[1]) == (1, 1)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, True, lens)
    _close(out, p_out, dtype, "out")
    torch.testing.assert_close(lse, p_lse, atol=1e-5, rtol=1e-5)
    for name, a, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                            fa.flash_bwd_plain(q, k, v, out, g, lse, True,
                                               lens)):
        _close(a, ref, dtype, name)
    assert all(bool(torch.isfinite(x.float()).all())
               for x in (out, dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_sampler_at_gpt2_vocabulary_matches_plain(device, dtype):
    plan = gs.gumbel_plan(64, V5)
    assert not plan["vec4"] and plan["cluster"] > 1
    assert plan["chunk"] * plan["cluster"] >= V5 > plan["chunk"] * (
        plan["cluster"] - 1)
    logits = _x((64, V5), 3, device, dtype, 3.0)
    u = torch.rand((64, V5), generator=torch.Generator(device=device)
                   .manual_seed(1), device=device)
    before = gs.gumbel_sample.launches
    soft, ids = gs.gumbel_sample(logits, 2.0, uniforms=u)
    torch.cuda.synchronize()
    assert gs.gumbel_sample.launches - before == 1
    p_soft, p_ids = gs.gumbel_sample_plain(logits, 2.0, u)
    _close(soft, p_soft, dtype, "soft")
    x = (logits.float() - torch.log(-torch.log(u + gs.EPS) + gs.EPS)) * 2.0
    top = x.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) <= TIE_GAP
    assert bool(((ids == p_ids) | near).all())
    # the Philox draw: its uniforms, fed back, give the same sample
    u_out = torch.empty_like(u)
    s_a, i_a = gs.gumbel_sample(logits, 2.0, seed=7, step=11,
                                uniforms_out=u_out)
    s_b, i_b = gs.gumbel_sample(logits, 2.0, uniforms=u_out)
    assert torch.equal(i_a, i_b) and torch.equal(s_a, s_b)
    assert bool((u_out >= 0).all() and (u_out < 1).all())


def test_sampler_ties_across_ctas_go_to_the_lowest_index(device):
    """Equal maxima in the first CTA's slice, the last CTA's partial slice
    and its last column: the id is the lowest of them."""
    plan = gs.gumbel_plan(64, V5)
    cols = [5, plan["chunk"] * (plan["cluster"] - 1) + 3, V5 - 1]
    logits = torch.zeros((64, V5), device=device)
    logits[:, cols] = 10.0
    logits[1:, cols[0]] = 0.0          # row r > 0: the later two tie
    logits[2:, cols[1]] = 0.0          # row r > 1: the last column alone
    u = torch.full((64, V5), 0.5, device=device)
    soft, ids = gs.gumbel_sample(logits, 1.0, uniforms=u)
    want = torch.full((64,), cols[2], dtype=torch.int32, device=device)
    want[0], want[1] = cols[0], cols[1]
    assert torch.equal(ids, want)
    torch.testing.assert_close(soft.sum(dim=-1), torch.ones(64,
                                                           device=device))
