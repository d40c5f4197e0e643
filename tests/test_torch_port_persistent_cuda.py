"""The persistent decode and reverse BPTT kernels (one cooperative launch
per call) against their plain PyTorch versions on the card, at the edges
of their launch plans: batch rows 1, 33 and 65, hidden widths that do not
divide into the blocks, vocabularies that are not a multiple of the
64-row tile, nl in {1, 3}, T in {1, 2}, and one shape whose weight slice
does not fit in shared memory (the streamed branch).  Every test skips
without CUDA.  This file imports torch and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_persistent_cuda.py

Each kernel output is held against the plain step fed the kernel's own ids
(so a near-tie that the two sums break differently checks the rule, not
the tie): each kernel id within 1e-4 of the plain maximum score;
logprobs, logits, residuals and the carried state within 1e-4; soft and
noise within 1e-5.  Modes that share a score are bit-equal (sample and
sample_resid, pretrain and greedy, sample_embed and sample_resid, chained
chunks and one full decode).  The reverse: d_pre within 1e-4 of its
largest entry, dh0 and dc0 within 1e-4.
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import lstm_bptt
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

ATOL, SOFT_ATOL, ID_ATOL = 1e-4, 1e-5, 1e-4

# (B, V, E, H, nl, T): batch 1 / 33 / 65 (one row, a partial 32-row
# projection chunk, a second 64-row chunk), H % blocks != 0, V % 64 != 0,
# E and H not multiples of 4 (the padded rows of [x | h])
SHAPES = [(1, 300, 48, 40, 1, 1), (33, 301, 48, 42, 3, 2),
          (65, 257, 32, 36, 1, 2), (1, 130, 16, 24, 3, 2),
          (65, 64, 38, 21, 3, 1)]
# H = 1024, nl = 2: 16 gate rows x (E + H, 2H) do not fit in shared memory
STREAMED = (3, 130, 64, 1024, 2, 2)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, device, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(device)


def _decoder(V, E, H, nl, device, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    layers = [{"w_ih": _t(rng, device, 4 * H, E if l == 0 else H, scale=k),
               "w_hh": _t(rng, device, 4 * H, H, scale=k),
               "b_ih": _t(rng, device, 4 * H, scale=k),
               "b_hh": _t(rng, device, 4 * H, scale=k)} for l in range(nl)]
    return (layers, _t(rng, device, V, H, scale=4 * k),
            _t(rng, device, V, scale=0.1), _t(rng, device, V, E))


def _forced(dec, x0, ids, state=None, uniforms=None, temp=1.0):
    """The plain steps fed the kernel's ids: per step the scores [B, V]
    (logits, plus the Gumbel noise of ``uniforms``), the logits, and every
    layer's h, c and gates; then the final (h, c)."""
    layers, w_proj, b_proj, embed = dec
    B, H = x0.shape[0], layers[0]["w_hh"].shape[1]
    if state is None:
        h = [x0.new_zeros(B, H) for _ in layers]
        c = [x0.new_zeros(B, H) for _ in layers]
    else:
        h, c = list(state[0]), list(state[1])
    x, out = x0, {"scores": [], "logits": [], "hs": [], "cs": [],
                  "gates": [], "noise": []}
    for t in range(ids.shape[1]):
        gates = ds._stack_step(layers, x, h, c)
        logits = h[-1] @ w_proj.T + b_proj
        scores = logits
        if uniforms is not None:
            g = gumbel_noise(uniforms[t].shape, u=uniforms[t])
            out["noise"].append(g)
            scores = logits + g
        for key, v in (("scores", scores), ("logits", logits),
                       ("hs", torch.stack(h)), ("cs", torch.stack(c)),
                       ("gates", torch.stack(gates))):
            out[key].append(v)
        x = embed[ids[:, t].long()]
    out = {k: torch.stack(v) for k, v in out.items() if v}
    out["soft"] = torch.softmax(out["scores"] * temp, dim=-1)
    return out, (torch.stack(h), torch.stack(c))


def _check_ids(ids, scores):
    chosen = scores.gather(2, ids.T.long()[..., None])[..., 0]
    gap = float((scores.max(dim=2).values - chosen).max())
    assert gap <= ID_ATOL, f"kernel id {gap} below the max score"


def _close(a, b, atol=ATOL):
    torch.testing.assert_close(a, b, atol=atol, rtol=0)


def _inputs(shape, device, seed=0):
    B, V, E, H, nl, T = shape
    dec = _decoder(V, E, H, nl, device, seed)
    rng = np.random.default_rng(seed + 1)
    feats = _t(rng, device, B, E)
    u = torch.from_numpy(rng.random((T, B, V)).astype(np.float32)).to(device)
    return dec, feats, u


def _branch_count(plan_resident):
    return ds.branches["resident" if plan_resident else "streamed"]


@pytest.mark.parametrize("shape", SHAPES + [STREAMED])
def test_greedy_modes_match_plain(device, shape):
    B, V, E, H, nl, T = shape
    dec, feats, _ = _inputs(shape, device)
    resident = ds.persistent_plan(B, E, H, V, nl, *ds.build.device_limits(
        ds._library(), device))["resident"]
    assert resident == (shape != STREAMED)
    before = (ds.decode_sample.launches, _branch_count(resident))
    ids, lps = ds.decode_sample(feats, *dec, T, mode="serve")
    assert (ds.decode_sample.launches, _branch_count(resident)) == (
        before[0] + 1, before[1] + 1)
    assert ds.last_plan["resident"] == resident
    greedy = ds.decode_sample(feats, *dec, T, mode="greedy")
    ids_l, logits = ds.decode_sample_logits(feats, *dec, T)
    torch.cuda.synchronize()
    forced, _ = _forced(dec, feats, ids)
    _check_ids(ids, forced["logits"])
    want_lps = (forced["logits"].gather(2, ids.T.long()[..., None])[..., 0]
                - torch.logsumexp(forced["logits"], dim=2)).T
    _close(lps, want_lps)
    assert torch.equal(greedy, ids) and torch.equal(ids_l, ids)
    _close(logits, forced["logits"])


@pytest.mark.parametrize("shape", SHAPES + [STREAMED])
def test_gumbel_modes_match_plain(device, shape):
    B, V, E, H, nl, T = shape
    dec, feats, u = _inputs(shape, device, seed=3)
    temp = 2.0
    rng = np.random.default_rng(7)
    wd = _t(rng, device, 24, V, scale=0.1)
    u_out = torch.empty_like(u)
    ids, soft, hs, cs, gates = ds.decode_sample_resid(
        feats, *dec, T, temperature=temp, uniforms=u, uniforms_out=u_out)
    ids_n, noise = ds.decode_sample_noise(feats, *dec, T, uniforms=u)
    emb_out = ds.decode_sample_embed(feats, *dec, T, wd, temperature=temp,
                                     uniforms=u)
    seeded_r = ds.decode_sample_resid(feats, *dec, T, seed=5,
                                      temperature=temp)[0]
    seeded_n = ds.decode_sample_noise(feats, *dec, T, seed=5)[0]
    torch.cuda.synchronize()
    forced, _ = _forced(dec, feats, ids, uniforms=u, temp=temp)
    _check_ids(ids, forced["scores"])
    _close(soft, forced["soft"], SOFT_ATOL)
    _close(hs, forced["hs"])
    _close(cs, forced["cs"])
    _close(gates, forced["gates"])
    assert torch.equal(u_out, u)
    assert torch.equal(ids_n, ids) and torch.equal(seeded_n, seeded_r)
    _close(noise, forced["noise"], SOFT_ATOL)
    assert torch.equal(emb_out[0], ids)
    for a, b in zip(emb_out[2:], (soft, hs, cs, gates)):
        assert torch.equal(a, b)
    want = (soft.double() @ wd.double().T).float()
    _close(emb_out[1], want, SOFT_ATOL * float(want.abs().max()))


@pytest.mark.parametrize("shape", SHAPES + [STREAMED])
def test_carried_chain_matches_plain(device, shape):
    B, V, E, H, nl, T = shape
    dec, feats, _ = _inputs(shape, device, seed=11)
    steps = T + 3
    ids, lps = ds.decode_sample(feats, *dec, steps, mode="serve")
    h = torch.zeros(nl, B, H, device=device)
    c, x, parts, t = h.clone(), feats, [], 0
    while t < steps:
        k = min(T, steps - t)
        i, lp, (h, c, x) = ds.decode_sample(x, *dec, k, mode="serve",
                                            init_state=(h, c, x))
        parts.append((i, lp))
        t += k
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([p[0] for p in parts], 1), ids)
    _close(torch.cat([p[1] for p in parts], 1), lps, 1e-6)
    # one chunk from a non-zero state against the plain steps
    rng = np.random.default_rng(12)
    st = (_t(rng, device, nl, B, H, scale=0.5),
          _t(rng, device, nl, B, H, scale=0.5), _t(rng, device, B, E))
    i, lp, (hT, cT, xT) = ds.decode_sample_carry(st[2], *dec, T,
                                                 init_state=st)
    torch.cuda.synchronize()
    forced, (h_p, c_p) = _forced(dec, st[2], i, state=st[:2])
    _check_ids(i, forced["logits"])
    want_lps = (forced["logits"].gather(2, i.T.long()[..., None])[..., 0]
                - torch.logsumexp(forced["logits"], dim=2)).T
    _close(lp, want_lps)
    _close(hT, h_p)
    _close(cT, c_p)
    assert torch.equal(xT, dec[3][i[:, -1].long()])


def _reverse_inputs(T, B, H, device, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    c_all = _t(rng, device, T + 1, B, H, scale=0.5)   # a non-zero c0
    return (_t(rng, device, H, 4 * H, scale=k), _t(rng, device, T, B, H),
            _t(rng, device, T, B, 4 * H), c_all[:-1].contiguous(),
            c_all[1:].contiguous())


@pytest.mark.parametrize("T,B,H", [(1, 1, 8), (2, 33, 40), (5, 65, 130),
                                   (3, 4, 2048)])
def test_reverse_matches_plain(device, T, B, H):
    args = _reverse_inputs(T, B, H, device, seed=T + B)
    resident = lstm_bptt.reverse_plan(B, H, *ds.build.device_limits(
        lstm_bptt._library(), device))["resident"]
    assert resident == (H != 2048)
    before = (lstm_bptt.lstm_bptt_reverse.launches,
              lstm_bptt.lstm_bptt_reverse.branches[
                  "resident" if resident else "streamed"])
    got = lstm_bptt.lstm_bptt_reverse(*args)
    assert (lstm_bptt.lstm_bptt_reverse.launches,
            lstm_bptt.lstm_bptt_reverse.branches[
                "resident" if resident else "streamed"]) == (
        before[0] + 1, before[1] + 1)
    want = lstm_bptt.lstm_bptt_reverse_plain(*args)
    torch.cuda.synchronize()
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= ATOL * scale
    _close(got[1], want[1])
    _close(got[2], want[2])


def test_plans_that_cannot_be_co_resident_raise(device):
    n_sm, smem = ds.build.device_limits(ds._library(), device)
    with pytest.raises(ValueError, match="co-resident"):
        ds.persistent_plan(8, 512, 512, 11008, 2, n_sm, smem,
                           blocks=n_sm + 1)
    with pytest.raises(ValueError, match="co-resident"):
        lstm_bptt.reverse_plan(64, 512, n_sm, smem, blocks=9 * n_sm)
