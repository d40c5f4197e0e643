"""The fused flash-attention backward's launch plan
(``kernels/flash_attention.py:flash_bwd_plan``) and a numpy replay of its
kernel (``csrc/flash_attention.cu:flash_bwd_fused_kernel``), on the CPU.

The plan: every (b, h, row) is owned by exactly one block and one thread
slot in each phase, a block stays within 227 KB of shared memory and 1024
threads, the heads a block takes respect the budgets, shapes past T = 64 or
D = 32 go to the tiled route, and a shape no kernel takes raises.

The replay runs the kernel's two phases in its block partition and its sum
order, in float32: phase 1 per (head, query row, key slice) computes delta
from out and dO, then s, p (masked before the exponential), dp and ds for
each of the slice's keys, writes p and ds to the block's P and dS tiles
(NaN until written) and sums dq; phase 2 per (head, key row, query slice)
sums dv and dk from the tiles, reading only what phase 1 wrote.  It is held
against the gradients of the JAX package's ``flash_attention`` (its Pallas
kernels in interpret mode, as ``tests/test_torch_port_flash.py`` runs them)
on numpy inputs from a seed, at the three masks and a batch row of key
length 0.  Tolerance: ``GRAD`` of that file, atol 2e-5 / rtol 1e-4 (the
JAX package's own flash tolerance: float32 sums in another order).  The
kernel itself is held against the plain version on the card
(``tests/test_torch_port_tf_cuda.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_image_captioning_tpu.kernels import flash_attention as jfa
from gan_image_captioning_tpu_torch.kernels import flash_attention as tfa

GRAD = dict(atol=2e-5, rtol=1e-4)
MASKS = [(True, True), (True, False), (False, False), (False, True)]
SMEM_MAX, THREADS_MAX = 227 * 1024, 1024
# config4's calls (generator MLE / log-prob, discriminator, rollouts), the
# card tests' shapes, tiny ones, and the fused kernel's edges
FUSED = [(64, 37, 8, 32), (64, 36, 8, 16), (256, 36, 8, 16), (4, 37, 8, 32),
         (4, 36, 8, 16), (2, 35, 2, 8), (2, 5, 2, 8), (2, 9, 2, 8),
         (1, 1, 1, 8), (3, 64, 3, 32), (1, 64, 8, 24), (2, 33, 5, 16)]
TILED = [(2, 200, 2, 24), (1, 70, 1, 256), (2, 65, 2, 8), (2, 16, 2, 40)]


def _slots(plan, B, T, H):
    """Per block and thread, the (b, h, row, slice) it owns, as the kernel
    maps them (blockIdx -> batch row and first head, threadIdx -> head,
    row and slice); -1 for a dead slot."""
    G, ks, nt = plan["heads"], plan["slices"], plan["threads"]
    groups = -(-H // G)
    blk, tid = np.meshgrid(np.arange(B * groups), np.arange(nt),
                           indexing="ij")
    b, h0 = blk // groups, (blk % groups) * G
    gh = np.minimum(G, H - h0)
    s, r = tid % ks, tid // ks
    live = r < gh * T
    g, i = r // T, r % T
    return (np.where(live, b, -1), np.where(live, h0 + g, -1),
            np.where(live, i, -1), s, live)


@pytest.mark.parametrize("B,T,H,D", FUSED)
def test_fused_plan_owns_every_row_once_within_the_card(B, T, H, D):
    plan = tfa.flash_bwd_plan(T, H, D)
    assert plan["route"] == "fused"
    G, ks = plan["heads"], plan["slices"]
    assert G >= 1 and G & (G - 1) == 0 and G <= max(1, H)
    assert plan["threads"] % 32 == 0 and plan["threads"] >= ks * G * T
    assert plan["threads"] <= THREADS_MAX and plan["smem"] <= SMEM_MAX
    assert G == 1 or (plan["threads"] <= tfa.FB_THREADS
                      and plan["smem"] <= tfa.FB_SMEM)
    # a row's staged tiles (q, k, v, dO; out is read in place) and the P
    # and dS tiles
    dp, ld = plan["dp"], plan["ld"]
    assert dp >= D and dp in (16, 32)
    assert ld >= T and ld % 4 == 2 and ld < T + 4
    assert plan["smem"] == 4 * G * (4 * T * (dp + tfa.FT_PAD) + 2 * T * ld)
    # both phases read one thread map, (head, row, slice): phase 1 the row
    # as a query row, phase 2 as a key row; each (b, h, row) has exactly
    # one thread of each slice, in one block
    b, h, i, s, live = _slots(plan, B, T, H)
    for sl in range(ks):
        own = np.zeros((B, H, T), np.int64)
        sel = live & (s == sl)
        np.add.at(own, (b[sel], h[sel], i[sel]), 1)
        assert (own == 1).all(), sl
    assert tfa.flash_bwd_plan(T, H, D) is plan          # cached


def test_fused_plan_at_config4():
    gen = tfa.flash_bwd_plan(37, 8, 32)
    disc = tfa.flash_bwd_plan(36, 8, 16)
    # two heads a block: 256 blocks at B = 64, two or more a SM
    assert (gen["heads"], gen["threads"], gen["smem"]) == (2, 160, 65120)
    assert (disc["heads"], disc["threads"], disc["smem"]) == (2, 160, 44928)
    assert gen["ld"] == disc["ld"] == 38


@pytest.mark.parametrize("T", [5, 9, 35, 36, 37, 64])
def test_phase1_writes_of_a_warp_fall_in_distinct_banks(T):
    """Lanes (row i, slice s) of a warp write P[i][s + 2n]: 16 rows, 2
    slices, 32 banks."""
    ld = tfa.flash_bwd_plan(T, 1, 16)["ld"]
    rows = np.arange(16)[:, None]
    slices = np.arange(2)[None, :]
    for n in range(3):
        banks = (rows * ld + slices + 2 * n) % 32
        assert len(np.unique(banks)) == 32


@pytest.mark.parametrize("B,T,H,D", TILED)
def test_shapes_past_the_fused_kernel_go_tiled(B, T, H, D):
    assert tfa.flash_bwd_plan(T, H, D) == {"route": "tiled"}


@pytest.mark.parametrize("T,H,D", [(0, 2, 8), (4, 0, 8), (4, 2, 12),
                                   (4, 2, 264), (4, 2, 0)])
def test_impossible_shapes_raise(T, H, D):
    with pytest.raises(ValueError):
        tfa.flash_bwd_plan(T, H, D)


# ------------------------------------------------------------ the replay

F32 = np.float32


def _dot2(a, b):
    """``dot_row``: two float32 chains over the columns, c % 8 < 4 and
    c % 8 >= 4, then their sum."""
    a0, a1 = F32(0), F32(0)
    for c in range(len(a)):
        if c % 8 < 4:
            a0 = F32(a0 + F32(a[c] * b[c]))
        else:
            a1 = F32(a1 + F32(a[c] * b[c]))
    return F32(a0 + a1)


def _replay(q, k, v, out, dout, lse, lengths, causal):
    """The fused kernel's two phases, block by block and thread by thread
    in its order (a thread's sums over its keys or queries ascending; the
    slices' partial rows joined in slice order)."""
    B, T, H, D = q.shape
    plan = tfa.flash_bwd_plan(T, H, D)
    G, ks, ld = plan["heads"], plan["slices"], plan["ld"]
    scale = F32(1.0 / math.sqrt(D))
    dq, dk, dv = (np.full(q.shape, np.nan, F32) for _ in range(3))
    groups = -(-H // G)
    for blk in range(B * groups):
        b, h0 = blk // groups, (blk % groups) * G
        gh = min(G, H - h0)
        length = T if lengths is None else min(max(int(lengths[b]), 0), T)
        p_tile = np.full((gh, T, ld), np.nan, F32)
        ds_tile = np.full((gh, T, ld), np.nan, F32)
        slots = [(r // T, r % T) for r in range(gh * T)]
        # phase 1: (head g, query row i, key slice s)
        part = {}
        for g, i in slots:
            h = h0 + g
            nk = min(length, i + 1) if causal else length
            delta = _dot2(dout[b, i, h], out[b, i, h])
            for s in range(ks):
                acc = np.zeros(D, F32)
                for j in range(s, nk, ks):          # valid keys only
                    sc = F32(_dot2(q[b, i, h], k[b, j, h]) * scale)
                    dp = _dot2(dout[b, i, h], v[b, j, h])
                    p = F32(np.exp(F32(sc - lse[b, i, h])))
                    ds = F32(p * F32(dp - delta))
                    acc = (acc + ds * k[b, j, h]).astype(F32)
                    p_tile[g, i, j], ds_tile[g, i, j] = p, ds
                part[s] = acc
            dq[b, i, h] = sum(part[s] for s in range(ks)) * scale
        # phase 2: (head g, key row j, query slice s), after the barrier
        for g, j in slots:
            h = h0 + g
            ka, va = {}, {}
            for s in range(ks):
                dka, dva = np.zeros(D, F32), np.zeros(D, F32)
                if j < length:
                    for i in range(s, T, ks):
                        if causal and i < j:
                            continue
                        p, ds = p_tile[g, i, j], ds_tile[g, i, j]
                        assert not (np.isnan(p) or np.isnan(ds)), (i, j)
                        dva = (dva + p * dout[b, i, h]).astype(F32)
                        dka = (dka + ds * q[b, i, h]).astype(F32)
                ka[s], va[s] = dka, dva
            dk[b, j, h] = sum(ka[s] for s in range(ks)) * scale
            dv[b, j, h] = sum(va[s] for s in range(ks))
    return dq, dk, dv


def _forward(q, k, v, lengths, causal):
    """out and lse in float64 (a row with no valid key: out 0, lse -1e30,
    as the forward kernels write them), rounded to float32."""
    B, T, H, D = q.shape
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) / math.sqrt(D)
    ok = np.ones((B, 1, T, T), bool)
    if causal:
        ok &= np.tril(np.ones((T, T), bool))
    if lengths is not None:
        ok &= (np.arange(T)[None, :] < lengths[:, None])[:, None, None, :]
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.where(ok, np.exp(s - m), 0.0)
    l = e.sum(-1, keepdims=True)
    lse = np.where(l > 0, m + np.log(np.maximum(l, 1e-300)), -1e30)[..., 0]
    o = np.einsum("bhqk,bkhd->bqhd", e / np.maximum(l, 1e-300), v)
    return o.astype(F32), lse.transpose(0, 2, 1).astype(F32)


@pytest.mark.parametrize("T", [5, 9])
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_replay_matches_jax_gradients(T, causal, with_lengths):
    B, H, D = 2, 2, 8
    rng = np.random.default_rng(100 + T)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(F32)
                  for _ in range(4))
    # with lengths, batch row 0 has no valid key
    lens = (np.array([0, rng.integers(1, T + 1)], np.int32) if with_lengths
            else None)
    out, lse = _forward(q, k, v, lens, causal)
    got = _replay(q, k, v, out, g, lse, lens, causal)

    jl = None if lens is None else jnp.asarray(lens)
    want = jax.jit(jax.grad(
        lambda a, b_, c: jnp.sum(jfa.flash_attention(a, b_, c, causal, jl)
                                 * g), (0, 1, 2)))(q, k, v)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b_), err_msg=name, **GRAD)
    if with_lengths:
        # the empty row: zero gradients, not the NaN an unmasked exp(s +
        # 1e30) would give
        for a in got:
            assert (a[0] == 0).all()
