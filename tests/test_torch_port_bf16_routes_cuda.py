"""The bfloat16 instantiations of the rest of ``--dtype bfloat16`` against
their plain PyTorch versions on the card, in bfloat16: the decode modes
``sample`` (``kernel_rescore``) and ``sample_embed`` (``kernel_embed``),
the embed backward (``csrc/decode_embed_bwd.cu``, bfloat16 ``mma.sync``)
and the DXS backward of the conv banks (``mxu_dxs``), at small shapes,
unaligned ones and config3's width.  A bfloat16 call counts one launch, on
both the wrapper's ``launches`` and its ``bf16_launches``.  Every test
skips without CUDA.  This file imports torch and the port only, so it runs
on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_bf16_routes_cuda.py

Tolerances, those of ``tests/test_torch_port_bf16_cuda.py`` unloosened: a
bfloat16 output of the same bfloat16 inputs (the noise of the same
uniforms, the soft sample from the kernel's own top h, the embedding of
the kernel's own soft sample) within one bfloat16 step of each entry,
the embedding plus 1e-5 of its largest entry (the float32 embedding's own
tolerance in ``tests/test_torch_port_decode_modes_cuda.py``: at V = 11008
an entry's sum of signed terms can cancel to far below them, and float32
sums in another order then round it to another bfloat16 value); ids
equal, or the kernel's id a tie, within 4 units (2^-8 of the largest
|score|) of the plain version's max score when the plain version is fed
the kernel's ids; a bfloat16 carry (h, c, gates), and the embed
backward's bfloat16 d_htop (a product of d_logits rounded to bfloat16,
where a rounding can tip the other way), 2 units of the largest entry;
float32 results of bfloat16 inputs as their float32 instantiations are
held: 1e-4 of the largest entry (the embed backward's dWp and dbp, the
DXS backward's dW), 1e-5 times the larger of 1 and the largest (DXS,
db)."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

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


def _steps(a, b, what, floor=0.0):
    """Each entry equal or one bfloat16 step apart, plus ``floor`` of the
    largest entry."""
    a, b = a.float(), b.float()
    bound = (2.0 ** -7 * torch.maximum(a.abs(), b.abs())
             + floor * float(b.abs().max()))
    assert bool(((a - b).abs() <= bound
                 + torch.finfo(torch.float32).tiny).all()), what


def _f32_close(a, b, rel, what, floor=1e-30):
    assert a.dtype == torch.float32, what
    tol = rel * max(float(b.abs().max()), floor)
    assert float((a - b).abs().max()) <= tol, what


def _counts(fn):
    return fn.launches, fn.bf16_launches


def _plus_one(before, fn):
    return _counts(fn) == (before[0] + 1, before[1] + 1)


def _forced(weights, feats, ids, u, temp=1.0):
    """The plain bfloat16 decode fed the given ids → float32 scores,
    bfloat16 soft sample and residuals."""
    layers, w_proj, b_proj, embed = weights
    h, c = ds._zero_state(feats, layers)
    x, out = feats, {k: [] for k in ("scores", "soft", "hs", "cs", "gates")}
    for t in range(ids.shape[1]):
        gates = ds._stack_step(layers, x, h, c)
        s = ds._logits(h[-1], w_proj, b_proj) + gumbel_noise(u[t].shape,
                                                              u=u[t])
        out["scores"].append(s)
        out["soft"].append(torch.softmax(s * temp, dim=-1).to(BF))
        out["hs"].append(torch.stack(h))
        out["cs"].append(torch.stack(c).to(BF))
        out["gates"].append(torch.stack(gates).to(BF))
        x = embed[ids[:, t].long()]
    return {k: torch.stack(v) for k, v in out.items()}


def _assert_ties(scores_tm, ids):
    chosen = scores_tm.gather(2, ids.T.long()[..., None])[..., 0]
    gap = float((scores_tm.max(dim=2).values - chosen).max())
    assert gap <= 4 * UNIT * float(scores_tm.abs().max())


# an unaligned E, H % 4 != 0, a vocabulary tile edge, one and three
# layers, the streamed branch (H = 1024 x 2 layers), and config3's decode
SHAPES = [(1, 300, 48, 40, 2, 7), (33, 130, 30, 20, 1, 5),
          (8, 256, 64, 64, 3, 4), (4, 512, 256, 1024, 2, 3),
          (64, 11008, 512, 512, 2, 36)]


@pytest.mark.parametrize("B,V,E,H,nl,T", SHAPES)
def test_sample_bf16_matches_plain(device, B, V, E, H, nl, T):
    rng = np.random.default_rng(5 * B + V)
    weights = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    u = torch.from_numpy(rng.random((T, B, V), dtype=np.float32)).to(device)
    before = _counts(ds.decode_sample_noise)
    ids, noise = ds.decode_sample(feats, *weights, T, mode="sample",
                                  uniforms=u)
    assert _plus_one(before, ds.decode_sample_noise)
    assert noise.dtype == BF and ids.dtype == torch.int32
    _steps(noise, gumbel_noise(u.shape, u=u).to(BF), "noise")
    _assert_ties(_forced(weights, feats, ids, u)["scores"], ids)
    # the same Philox stream as sample_resid's: the same seed, the same ids
    ids_a, _ = ds.decode_sample(feats, *weights, T, mode="sample", seed=11)
    ids_b = ds.decode_sample(feats, *weights, T, mode="sample_resid",
                             seed=11)[0]
    assert torch.equal(ids_a, ids_b)


@pytest.mark.parametrize("B,V,E,H,nl,T,Ed", [
    (1, 300, 48, 40, 2, 7, 20), (33, 130, 30, 20, 1, 5, 8),
    (64, 11008, 512, 512, 2, 36, 64)])
def test_sample_embed_bf16_matches_plain(device, B, V, E, H, nl, T, Ed):
    rng = np.random.default_rng(7 * B + V)
    weights = _decoder(rng, V, E, H, nl, device)
    feats = _t(rng, device, B, E)
    wd = _t(rng, device, Ed, V, scale=0.02)
    u = torch.from_numpy(rng.random((T, B, V), dtype=np.float32)).to(device)
    before = _counts(ds.decode_sample_embed)
    ids, emb, soft, hs, cs, gates = ds.decode_sample(
        feats, *weights, T, mode="sample_embed", temperature=1.5,
        uniforms=u, disc_embed=wd)
    assert _plus_one(before, ds.decode_sample_embed)
    assert all(x.dtype == BF for x in (emb, soft, hs, cs, gates))
    ref = _forced(weights, feats, ids, u, 1.5)
    _assert_ties(ref["scores"], ids)
    for name, got in (("hs", hs), ("cs", cs), ("gates", gates)):
        _close(got, ref[name], 2, name)
    s = ds._logits(hs[:, -1], weights[1], weights[2]) + gumbel_noise(
        u.shape, u=u)
    _steps(soft, torch.softmax(s * 1.5, dim=-1).to(BF), "soft")
    _steps(emb, (soft.float() @ wd.float().T).to(BF), "emb", floor=1e-5)


@pytest.mark.parametrize("T,B,H,V,Ed", [
    (3, 5, 40, 300, 20), (2, 7, 130, 1001, 12), (36, 64, 512, 11008, 64)])
def test_embed_bwd_bf16_matches_plain(device, T, B, H, V, Ed):
    """Aligned rows (16-byte tile loads) and unaligned ones (element
    loads), and config3's [36 x 64 rows, V = 11008, H = 512, Ed = 64]."""
    rng = np.random.default_rng(T * V)
    h_top = _t(rng, device, T, B, H, scale=0.5)
    soft = torch.softmax(_t(rng, device, T, B, V, scale=3.0, dtype=torch
                            .float32), dim=-1).to(BF)
    d_emb = _t(rng, device, T, B, Ed, scale=0.1)
    w_proj = _t(rng, device, V, H, scale=H ** -0.5)
    wd = _t(rng, device, Ed, V, scale=0.02)
    args = (h_top, soft, d_emb, w_proj, wd, 1.75)
    before = _counts(ds.decode_sample_embed_bwd)
    dwp, dbp, d_htop = ds.decode_sample_embed_bwd(*args)
    assert _plus_one(before, ds.decode_sample_embed_bwd)
    want = ds.decode_sample_embed_bwd_plain(*args)
    _f32_close(dwp, want[0], 1e-4, "dWp")
    _f32_close(dbp, want[1], 1e-4, "dbp")
    assert d_htop.dtype == BF
    _close(d_htop, want[2], 2, "d_htop")
    # every sum in a fixed order: a second call gives the same bits
    again = ds.decode_sample_embed_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip((dwp, dbp, d_htop), again))


def _grads(device, rng, B, R, T, banks):
    maxf = max(f for _, f in banks)
    emb = torch.nn.functional.pad(_t(rng, device, B, T, R), (0, 0, 0,
                                                             maxf - 1))
    w_all = _t(rng, device, sum(n for n, _ in banks), maxf, scale=0.5)
    b_all = _t(rng, device, w_all.shape[0], scale=0.1)
    emb = emb.contiguous()
    pooled, idxs = disc_conv.conv_relu_maxpool_plain(emb, w_all, b_all,
                                                     banks, R, 1)
    return emb, w_all, pooled, idxs, _t(rng, device, *pooled.shape)


@pytest.mark.parametrize("B,R,T,banks", [
    (8, 4, 12, ((40, 3), (70, 4), (30, 5))),
    (3, 5, 9, ((7, 2), (33, 3))),
    (64, 64, 36, ((300, 3), (300, 4), (300, 5)))])
def test_dxs_bf16_matches_plain(device, B, R, T, banks):
    """The DXS backward's bfloat16 instantiation from the raw pooled
    gradient (``mxu_dxs``): DXS, dW and db float32; config3's banks at its
    width in the last case."""
    rng = np.random.default_rng(B * T)
    emb, w_all, pooled, idxs, d_pooled = _grads(device, rng, B, R, T, banks)
    before = _counts(disc_conv.conv_bank_dxs)
    dxss, dw, db = disc_conv.conv_bank_dxs_raw(emb, w_all, banks, R, 1,
                                               pooled, idxs, d_pooled)
    assert _plus_one(before, disc_conv.conv_bank_dxs)
    w_dxss, w_dw, w_db = disc_conv.conv_dxs_raw_plain(
        emb, w_all, banks, R, 1, pooled, idxs, d_pooled)
    for k, (a, b) in enumerate(zip(dxss, w_dxss)):
        _f32_close(a, b, 1e-5, f"dxs {k}", floor=1.0)
    _f32_close(dw, w_dw, 1e-4, "dW")
    _f32_close(db, w_db, 1e-5, "db", floor=1.0)
    d_emb = disc_conv.overlap_add(dxss, banks, emb.shape, R, 1)
    assert d_emb.dtype == torch.float32
