"""The flash-attention kernels (the fused forward and backward, key slices
up to D = 32 and column halves up to 64; the tiled forward and backward
past their shapes: the long captions of ``--max-seq-len 126``) and the fused Gumbel sampler against their
plain versions on the card, and the transformer GAN's steps through them.  Every test skips without CUDA.  This file
imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tf_cuda.py

Tolerances: flash outputs within 2e-6 of the dense plain version and
gradients within 1e-5 of the largest gradient (float32 sums in another
order; unit-scale inputs); the sampler's soft rows within 1e-6 and its ids
equal except where the top two ``x`` are within 1e-5 (two calls, and the
ids of every cluster size, bit-equal); the Philox draw's histogram of ids within
0.01 of ``softmax(logits)`` over 2^16 rows.
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
# the long captions of --max-seq-len 126 (seq_len 128, the tiled kernels):
# config4's generator, discriminator and rollouts, config5's generator;
# in SHAPES at B = 4, as the config4 shapes there, and at full B in
# test_flash_fwd_at_long_captions_matches_plain and
# test_flash_bwd_at_long_captions_matches_plain
LONG_SHAPES = [(64, 129, 8, 32), (64, 128, 8, 16), (256, 128, 8, 16),
               (64, 129, 12, 64)]
# (B, T, H, D): the generator's and the discriminator's shapes, ragged
# lengths, a head dim whose row needs a non-power-of-two thread count, the
# largest head dim
SHAPES = [(4, 37, 8, 32), (4, 36, 8, 16), (2, 35, 2, 8), (2, 200, 2, 24),
          (1, 70, 1, 256), (4, 129, 8, 32), (4, 128, 8, 16),
          (4, 129, 12, 64)]
# config4's discriminator over the rollouts and over a batch, at full B
CONFIG4_SHAPES = [(256, 36, 8, 16), (64, 36, 8, 16)]
# the column-half kernels (32 < D <= 64) at T = 1, 37 and 64, GPT-2's
# twelve heads among them, and a head dim past them (the tiled kernels)
COLUMN_SHAPES = [(2, 1, 3, 40), (4, 37, 3, 40), (2, 64, 2, 40),
                 (2, 1, 2, 48), (4, 37, 4, 48), (2, 64, 3, 48),
                 (2, 1, 12, 64), (4, 37, 12, 64), (2, 64, 3, 64)]
PAST_COLUMNS = [(2, 37, 2, 72)]


def _fused(shape):
    """Whether the fused kernels take the shape: T <= 64 and D <= 64."""
    return shape[1] <= 64 and shape[3] <= 64
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


def _forward_kernels(fn):
    """Names of the forward kernels (profiler events whose name holds
    ``flash_fwd``) that one call of ``fn`` launches; profiled again once
    where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if "flash_fwd" in e.name]
        if names:
            return names
    return names


def _lengths(b, t, causal, seed, device):
    rng = np.random.default_rng(seed)
    # causal with lengths: the MLE pass's lengths + 1 (never 0)
    return torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(
        device)


@pytest.mark.parametrize("shape", SHAPES + CONFIG4_SHAPES + COLUMN_SHAPES
                         + PAST_COLUMNS)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_matches_plain(device, shape, causal, with_lengths):
    q, k, v = _qkv(shape, sum(shape), device)
    lens = (_lengths(shape[0], shape[1], causal, 3, device) if with_lengths
            else None)
    kernels = (fa.flash_fwd, fa.flash_bwd)
    counts = [f.launches for f in kernels]
    out = fa.flash_attention(q, k, v, causal, lens)
    g = torch.randn(out.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    # one launch of the backward: where T <= 64 and D <= 64 the fused
    # kernel, else the tiled one, as the plan says from the shape alone
    fused = _fused(shape)
    assert [f.launches - c for f, c in zip(kernels, counts)] == [1, 1]
    assert fa.flash_bwd.last_kernel == ("fused" if fused else "tiled")
    assert fa.flash_bwd.last_kernel == fa.flash_bwd_plan(*shape[1:])["route"]
    ref = fa.attention_plain(q, k, v, causal, lens)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, atol=OUT_ATOL, rtol=0)
    tops = [float(b.abs().max()) for b in ref_grads]
    for name, a, b, top in zip("qkv", grads, ref_grads, tops):
        # a gradient that is zero in the plain version (dq and dk at T = 1:
        # one key, a constant softmax) is held to the largest gradient's
        # scale; every other to its own largest entry's
        err = float((a - b).abs().max())
        assert err <= GRAD_RTOL * (top or max(tops)), f"d{name}: {err}"
    # one launch of the fused forward where T <= 64 and D <= 64, else of
    # the tiled one (as the wrapper reports it, and by the profiler's name
    # where it saw the launch: flash_fwd_fused_kernel up to D = 32,
    # flash_fwd_fused64_kernel past it); the forward and the backward
    # repeat bit for bit
    assert fa.flash_fwd.last_kernel == ("fused" if fused else "tiled")
    qd, kd, vd = (x.detach() for x in (q, k, v))
    names = _forward_kernels(lambda: fa.flash_fwd(qd, kd, vd, causal, lens))
    want = ("flash_fwd_tiled_kernel" if not fused else
            "flash_fwd_fused_kernel" if shape[3] <= 32 else
            "flash_fwd_fused64_kernel")
    assert not names or (len(names) == 1 and want in names[0]), names
    again = fa.flash_fwd(qd, kd, vd, causal, lens)
    assert torch.equal(again[0], out)
    assert torch.equal(again[1], fa.flash_fwd(qd, kd, vd, causal, lens)[1])
    bwd = [fa.flash_bwd(qd, kd, vd, again[0], g, again[1], causal, lens)
           for _ in range(2)]
    for a, b, c in zip(grads, *bwd):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("shape", LONG_SHAPES)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_bwd_at_long_captions_matches_plain(device, shape, causal,
                                                  with_lengths):
    """The tiled backward at the long captions' full batch: one launch,
    no PyTorch delta (the kernel's own out and lse in, its gradients
    within GRAD_RTOL of the plain version's autograd on the same inputs),
    and a second call bit-equal.  The forward at these shapes: in
    test_flash_fwd_at_long_captions_matches_plain."""
    q, k, v = (x.detach() for x in _qkv(shape, sum(shape) + 1, device))
    lens = (_lengths(shape[0], shape[1], causal, 3, device) if with_lengths
            else None)
    g = torch.randn(shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(4))
    out, lse = fa.flash_fwd(q, k, v, causal, lens)
    before = fa.flash_bwd.launches
    grads = fa.flash_bwd(q, k, v, out, g, lse, causal, lens)
    torch.cuda.synchronize()
    assert fa.flash_bwd.launches - before == 1
    assert fa.flash_bwd.last_kernel == "tiled"
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(fa.attention_plain(*qkv, causal, lens), qkv, g)
    for name, a, b in zip("qkv", grads, ref):
        err = float((a - b).abs().max())
        assert err <= GRAD_RTOL * float(b.abs().max()), f"d{name}: {err}"
    again = fa.flash_bwd(q, k, v, out, g, lse, causal, lens)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("shape", LONG_SHAPES)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_flash_fwd_at_long_captions_matches_plain(device, shape, causal,
                                                  with_lengths):
    """The tiled forward at the long captions' full batch: one launch of
    flash_fwd_tiled_kernel (as the wrapper reports it, and by the
    profiler's name where it saw the launch), out within OUT_ATOL of the
    dense plain version on the same inputs in float64 (the exact answer:
    at these 4-6 M outputs the float32 plain version is itself up to
    2.1e-6 from it), and a second call bit-equal (out and lse)."""
    q, k, v = (x.detach() for x in _qkv(shape, sum(shape) + 2, device))
    lens = (_lengths(shape[0], shape[1], causal, 5, device) if with_lengths
            else None)
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, lens)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches - before == 1
    assert fa.flash_fwd.last_kernel == "tiled"
    assert fa.flash_fwd_plan(*shape[1:])["route"] == "tiled"
    ref = fa.attention_plain(q.double(), k.double(), v.double(), causal,
                             lens)
    torch.testing.assert_close(out.double(), ref, atol=OUT_ATOL, rtol=0)
    del ref
    names = _forward_kernels(lambda: fa.flash_fwd(q, k, v, causal, lens))
    assert not names or (len(names) == 1
                         and "flash_fwd_tiled_kernel" in names[0]), names
    again = fa.flash_fwd(q, k, v, causal, lens)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[3]]
                         + COLUMN_SHAPES[1::3] + PAST_COLUMNS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_row_of_length_zero(device, shape, causal):
    """A batch row with no valid key: dq, dk and dv 0 there, dk and dv 0
    past every row's length, all finite; the other rows as the plain
    version (whose empty row spreads a uniform softmax over v)."""
    q, k, v = _qkv(shape, 10, device)
    lens = _lengths(shape[0], shape[1], causal, 5, device)
    lens[1] = 0
    g = torch.randn(shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(2))
    grads = torch.autograd.grad(fa.flash_attention(q, k, v, causal, lens),
                                (q, k, v), g)
    torch.cuda.synchronize()
    assert fa.flash_bwd.last_kernel == ("fused" if _fused(shape) else
                                        "tiled")
    for a in grads:
        assert bool(torch.isfinite(a).all())
        assert float(a[1].abs().max()) == 0.0
    past = (torch.arange(shape[1], device=device)[None, :]
            >= lens[:, None].long())                  # [B, T] keys past len
    for a in grads[1:]:
        assert float(a[past].abs().max()) == 0.0
    keep = torch.arange(shape[0], device=device) != 1
    ref = torch.autograd.grad(fa.attention_plain(q, k, v, causal, lens),
                              (q, k, v), g)
    for name, a, b in zip("qkv", grads, ref):
        err = float((a[keep] - b[keep]).abs().max() / b[keep].abs().max())
        assert err <= GRAD_RTOL, f"d{name}: {err}"


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[3]]
                         + COLUMN_SHAPES[1::3] + PAST_COLUMNS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_row_of_length_zero(device, shape, causal):
    """A batch row with no valid key: out 0 and lse about -1e30 (the TPU
    kernel's finite fill); the other rows as the plain version."""
    q, k, v = (x.detach() for x in _qkv(shape, 9, device))
    lens = _lengths(shape[0], shape[1], causal, 4, device)
    lens[1] = 0
    out, lse = fa.flash_fwd(q, k, v, causal, lens)
    torch.cuda.synchronize()
    assert float(out[1].abs().max()) == 0.0
    assert float(lse[1].max()) <= -1e29
    keep = torch.arange(shape[0], device=device) != 1
    ref = fa.attention_plain(q, k, v, causal, lens)
    torch.testing.assert_close(out[keep], ref[keep], atol=OUT_ATOL, rtol=0)
    assert bool(torch.isfinite(lse[keep]).all())


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_refuses_unaligned(device, which):
    """A q, k or v view at an offset that is not a multiple of 16 bytes
    raises (the fused forward copies 16 bytes at a time)."""
    shape = (4, 36, 8, 16)
    qkv = [x.detach() for x in _qkv(shape, 2, device)]
    flat = torch.empty(qkv[which].numel() + 1, device=device)
    qkv[which] = flat[1:].view(shape).copy_(qkv[which])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(*qkv, False)


@pytest.mark.parametrize("shape", [(4, 36, 8, 16), (4, 37, 12, 64)])
def test_flash_bwd_refuses_unaligned_and_a_foreign_plan(device, monkeypatch,
                                                        shape):
    """The fused backward stages out and dO by 16-byte copies: a view at
    another offset raises; a plan that does not cover the kernel's layout
    (a byte of shared memory short, or fewer than two threads a row) or
    passes the card's limits is refused by the C side; none launches."""
    t, h, d = shape[1:]
    q, k, v = (x.detach() for x in _qkv(shape, 6, device))
    out, lse = fa.flash_fwd(q, k, v, False)
    flat = torch.empty(out.numel() + 1, device=device)
    odd = flat[1:].view(shape).copy_(out)
    before = fa.flash_bwd.launches
    for o, g in ((odd, out), (out, odd)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_bwd(q, k, v, o, g, lse, False)
    plan = fa.flash_bwd_plan(t, h, d)
    assert plan["heads"] == (2 if d <= 32 else 1)
    for bad in ({"smem": plan["smem"] - 1},
                {"threads": plan["threads"] - 32},
                {"heads": 4, "threads": 512, "smem": 2 * plan["smem"]},
                {"smem": 228 * 1024}):
        monkeypatch.setattr(fa, "flash_bwd_plan",
                            lambda t_, h_, d_, bad=bad: {**plan, **bad})
        with pytest.raises(RuntimeError):
            fa.flash_bwd(q, k, v, out, out, lse, False)
    assert fa.flash_bwd.launches == before


@pytest.mark.parametrize("shape", [(2, 129, 8, 32), (1, 70, 1, 256)])
def test_flash_tiled_bwd_refuses_a_foreign_plan(device, monkeypatch, shape):
    """The tiled backward's plan is checked as the fused one's: a byte of
    shared memory short, other threads or another head dim is refused and
    launches nothing; its dQ sums in shared memory (config4's generator)
    or in scratch (D = 256) as the plan says."""
    t, h, d = shape[1:]
    q, k, v = (x.detach() for x in _qkv(shape, 8, device))
    out, lse = fa.flash_fwd(q, k, v, True)
    plan = fa.flash_bwd_plan(t, h, d)
    assert plan["route"] == "tiled"
    assert plan["ws"] == ("shared" if d <= 64 else "global")
    before = fa.flash_bwd.launches
    for bad in ({"smem": plan["smem"] - 1}, {"threads": 256},
                {"dp": 2 * plan["dp"]}, {"smem": 228 * 1024}):
        monkeypatch.setattr(fa, "flash_bwd_plan",
                            lambda t_, h_, d_, bad=bad: {**plan, **bad})
        with pytest.raises(RuntimeError):
            fa.flash_bwd(q, k, v, out, out, lse, True)
    assert fa.flash_bwd.launches == before


@pytest.mark.parametrize("shape", [(2, 129, 8, 32), (1, 70, 1, 256)])
def test_flash_tiled_fwd_refuses_a_foreign_plan(device, monkeypatch, shape):
    """The tiled forward's plan is checked as the tiled backward's: a byte
    of shared memory short, other threads, another head dim, more than a
    block may use, or query or key tiles the C side does not build is
    refused and launches nothing."""
    t, h, d = shape[1:]
    q, k, v = (x.detach() for x in _qkv(shape, 9, device))
    plan = fa.flash_fwd_plan(t, h, d)
    assert plan["route"] == "tiled"
    before = fa.flash_fwd.launches
    for bad in ({"smem": plan["smem"] - 1}, {"threads": 256},
                {"dp": 2 * plan["dp"]}, {"smem": 228 * 1024},
                {"q_rows": 32}, {"k_rows": 16}, {"k_rows": 64}):
        monkeypatch.setattr(fa, "flash_fwd_plan",
                            lambda t_, h_, d_, bad=bad: {**plan, **bad})
        with pytest.raises(RuntimeError):
            fa.flash_fwd(q, k, v, True)
    assert fa.flash_fwd.launches == before


def test_flash_fwd_refuses_a_foreign_plan(device, monkeypatch):
    """The forward's plan is checked as the backward's: a byte of shared
    memory short is refused and launches nothing."""
    q, k, v = (x.detach() for x in _qkv((2, 37, 12, 64), 7, device))
    plan = fa.flash_fwd_plan(37, 12, 64)
    before = fa.flash_fwd.launches
    monkeypatch.setattr(fa, "flash_fwd_plan",
                        lambda t, h, d: {**plan, "smem": plan["smem"] - 1})
    with pytest.raises(RuntimeError):
        fa.flash_fwd(q, k, v, True)
    assert fa.flash_fwd.launches == before


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


# the sampler's plans: config4's [64, V] (clusters of 2) and one row
# (clusters of 8), 256 rows (one CTA a row), a warp per row (V = 16),
# GPT-2's vocabulary and V not a multiple of 4 (scalar accesses), small
# rows; at temperatures 1 and 100, and the earlier cases
GUMBEL_SHAPES = [(64, 11008), (1, 11008), (256, 11008), (4096, 16),
                 (3, 50257), (64, 11007), (3, 1000), (5, 257)]
GUMBEL_CASES = [(b, v, t) for b, v in GUMBEL_SHAPES for t in (1.0, 100.0)
                ] + [(64, 11008, 10.0), (5, 257, 0.5)]


@pytest.mark.parametrize("B,V,temp", GUMBEL_CASES)
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
    # two calls, fed or drawn: the same bits; the draw is the kernel fed
    # the uniforms it drew
    again = gs.gumbel_sample(logits, temp, uniforms=u)
    assert torch.equal(soft, again[0]) and torch.equal(ids, again[1])
    u_out = torch.empty_like(u)
    drawn = gs.gumbel_sample(logits, temp, seed=11, step=2,
                             uniforms_out=u_out)
    for other in (gs.gumbel_sample(logits, temp, seed=11, step=2),
                  gs.gumbel_sample(logits, temp, uniforms=u_out)):
        assert torch.equal(drawn[0], other[0])
        assert torch.equal(drawn[1], other[1])


def test_gumbel_every_cluster_size_gives_the_same_ids(device):
    # the plan takes 8, 4, 2 and 1 CTAs a row at 1, 32, 64 and 128 rows;
    # row b draws Philox (seed, step, b) at any B, so the first rows of the
    # same logits give the same x whatever the split: the same first argmax
    V = 11008
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((128, V)).astype(
        np.float32) * 3).to(device)
    soft, ids = gs.gumbel_sample(logits, 1.0, seed=4, step=1)
    assert gs.gumbel_plan(128, V)["cluster"] == 1
    for B, cluster in ((1, 8), (32, 4), (64, 2)):
        assert gs.gumbel_plan(B, V)["cluster"] == cluster
        got = gs.gumbel_sample(logits[:B].contiguous(), 1.0, seed=4, step=1)
        assert torch.equal(got[1], ids[:B])
        torch.testing.assert_close(got[0], soft[:B], atol=SOFT_ATOL, rtol=0)


def test_gumbel_refuses_a_row_past_its_registers(device):
    logits = torch.zeros((1, gs.G_V_MAX + 4), device=device)
    before = gs.gumbel_sample.launches
    with pytest.raises(ValueError, match="passes"):
        gs.gumbel_sample(logits, 1.0, seed=1)
    assert gs.gumbel_sample.launches == before


@pytest.mark.parametrize("B,V", [(3, 11008), (3, 11007), (3, 16)])
def test_gumbel_rows_of_minus_inf_or_nan_take_id_0(device, B, V):
    # row 0 all -inf (every x at the maximum: the first index), row 1 all
    # NaN (no x reaches a maximum: 0), row 2 ordinary
    logits = torch.randn((B, V), device=device)
    logits[0] = -float("inf")
    logits[1] = float("nan")
    u = torch.rand((B, V), device=device)
    soft, ids = gs.gumbel_sample(logits, 1.0, uniforms=u)
    soft_p, ids_p = gs.gumbel_sample_plain(logits, 1.0, u)
    assert ids[:2].tolist() == [0, 0]
    assert bool(torch.isnan(soft[:2]).all())
    assert int(ids[2]) == int(ids_p[2])
    torch.testing.assert_close(soft[2], soft_p[2], atol=SOFT_ATOL, rtol=0)


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
    return {"fwd": fa.flash_fwd.launches, "bwd": fa.flash_bwd.launches,
            "gumbel": gs.gumbel_sample.launches}


@pytest.mark.parametrize("max_seq_len", [6, 126])
@pytest.mark.parametrize("objective", ["reinforce", "gumbel"])
def test_steps_launch_the_kernels_and_match_the_plain_route(device,
                                                             objective,
                                                             max_seq_len):
    """At the default caption length every attention takes the fused
    kernels; at --max-seq-len 126 (T + 1 = 129 generator positions, 128
    discriminator ones) every backward takes the tiled kernel, one launch
    a layer as before (no PyTorch delta)."""
    config = Config(**KW).replace(adv_objective=objective,
                                  max_seq_len=max_seq_len,
                                  rollout_stride=max(3, max_seq_len // 2))
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
    want_route = "fused" if T <= 64 else "tiled"
    for t_, h_, e_ in ((T, config.disc_num_heads, config.disc_hidden_dim),
                       (T + 1, config.gen_num_heads, config.gen_hidden_dim)):
        assert fa.flash_bwd_plan(t_, h_, e_ // h_)["route"] == want_route
    if objective == "reinforce":
        # sample T Gumbel launches; flash forward: 2 training disc passes,
        # the rollout prefixes + the full score, the greedy baseline, the
        # log-prob pass; backward (one launch a layer): the 2 training
        # passes and the log-prob
        gl = config.gen_num_layers
        prefixes = len(range(config.rollout_stride, T,
                             config.rollout_stride))
        assert launched == {"gumbel": T,
                            "fwd": nl * (2 + prefixes + 1 + 1) + gl,
                            "bwd": 2 * nl + gl}
    else:
        assert launched == {"gumbel": T, "fwd": 3 * nl, "bwd": 3 * nl}
        assert fa.flash_bwd.last_kernel == want_route
