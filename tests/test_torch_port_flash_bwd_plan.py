"""The fused flash-attention kernels' launch plans
(``kernels/flash_attention.py:flash_fwd_plan`` and ``flash_bwd_plan``, the
only place their route and G are chosen) and a numpy replay of the fused
backward (``csrc/flash_attention.cu:flash_bwd_fused_kernel`` at D ≤ 32 and
``flash_bwd_fused64_kernel`` at 32 < D ≤ 64), on the CPU.

The plans: every (b, h, row) is owned by exactly one block and one thread
slot in each phase, a block stays within 227 KB of shared memory and its
kernel's launch bounds, the heads a block takes respect the budgets, shapes
past T = 64 or D = 64 go to the tiled route (``flash_bwd_tiled_kernel``:
one (b, h) a block, within the card at any T, its walk over (key tile,
query tile) steps covering every valid pair, row and K chunk once, and a
float32 replay of that walk against the JAX gradients), and a shape no
kernel takes raises.

The replay runs the kernel's two phases in its block partition and its sum
order, in float32.  At D ≤ 32 (key slices): phase 1 per (head, query row,
key slice) computes delta from out and dO, then s, p (masked before the
exponential), dp and ds for each of the slice's keys, writes p and ds to
the block's P and dS tiles (NaN until written) and sums dq; phase 2 per
(head, key row, query slice) sums dv and dk from the tiles, reading only
what phase 1 wrote.  At D = 64 (column halves): each dot product is two
half-row partial sums, each over its thread's float4 chunks on two chains,
joined by one sum; phase 1 per (head, query row) takes every key in order
and writes the (p, ds) pairs, phase 2 per (head, key row) every query in
order, and a thread's dq, dk or dv columns are whole sums.  It is held
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
# config4's calls (generator MLE / log-prob, discriminator, rollouts),
# config5's GPT-2 MLE pass, the card tests' shapes, tiny ones, and the
# fused kernels' edges (T = 1 and 64 at each head dim past 32)
FUSED = [(64, 37, 8, 32), (64, 36, 8, 16), (256, 36, 8, 16), (4, 37, 8, 32),
         (4, 36, 8, 16), (2, 35, 2, 8), (2, 5, 2, 8), (2, 9, 2, 8),
         (1, 1, 1, 8), (3, 64, 3, 32), (1, 64, 8, 24), (2, 33, 5, 16),
         (2, 16, 2, 40), (64, 37, 12, 64), (2, 9, 3, 64),
         (1, 1, 1, 40), (2, 64, 3, 40), (1, 1, 2, 48), (2, 64, 2, 48),
         (1, 1, 3, 56), (2, 64, 1, 56), (1, 1, 12, 64), (2, 64, 12, 64)]
TILED = [(2, 200, 2, 24), (1, 70, 1, 256), (2, 65, 2, 8), (2, 16, 2, 72),
         (2, 65, 2, 64), (1, 1, 1, 72)]
# the long captions of --max-seq-len 126: config4's generator,
# discriminator and rollouts, config5's generator
LONG = [(64, 129, 8, 32), (64, 128, 8, 16), (256, 128, 8, 16),
        (64, 129, 12, 64)]
PLANS = {"fwd": tfa.flash_fwd_plan, "bwd": tfa.flash_bwd_plan}


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


def _owns_every_row_once(plan, B, T, H):
    """Each (b, h, row) has exactly one thread of each slice, in one
    block (both phases read one thread map, (head, row, slice))."""
    b, h, i, s, live = _slots(plan, B, T, H)
    for sl in range(plan["slices"]):
        own = np.zeros((B, H, T), np.int64)
        sel = live & (s == sl)
        np.add.at(own, (b[sel], h[sel], i[sel]), 1)
        assert (own == 1).all(), sl


def _within_the_card(plan, kind, T, H, D):
    G, ks = plan["heads"], plan["slices"]
    most, budget = tfa.BUDGETS[(kind, plan["split"])]
    assert G >= 1 and G & (G - 1) == 0 and G <= max(1, H)
    assert plan["threads"] % 32 == 0 and plan["threads"] >= ks * G * T
    assert plan["threads"] <= min(most, THREADS_MAX) == plan["most_threads"]
    assert plan["smem"] <= SMEM_MAX
    assert G == 1 or plan["smem"] <= budget
    # the design by head dim: two key slices up to 32 columns (rows of 16
    # or 32 floats), two column halves of a 64-float row past that
    assert plan["dp"] >= D
    assert (plan["dp"], plan["split"]) in ((16, "keys"), (32, "keys"),
                                           (64, "columns"))
    assert plan["split"] == ("keys" if D <= 32 else "columns")


@pytest.mark.parametrize("B,T,H,D", FUSED)
def test_fused_plan_owns_every_row_once_within_the_card(B, T, H, D):
    plan = tfa.flash_bwd_plan(T, H, D)
    assert plan["route"] == "fused"
    _within_the_card(plan, "bwd", T, H, D)
    G, dp, ld = plan["heads"], plan["dp"], plan["ld"]
    rs = dp + tfa.FT_PAD
    if plan["split"] == "keys":
        # a row's staged tiles (q, k, v, dO; out is read in place) and the
        # P and dS tiles
        assert ld >= T and ld % 4 == 2 and ld < T + 4
        assert plan["smem"] == 4 * G * T * (4 * rs + 2 * ld)
    else:
        # the staged tiles and the (p, ds) pairs, an odd number a row
        assert ld in (T, T + 1) and ld % 2 == 1
        assert plan["smem"] == 4 * G * T * (4 * rs + 2 * ld)
    _owns_every_row_once(plan, B, T, H)
    assert tfa.flash_bwd_plan(T, H, D) is plan          # cached


@pytest.mark.parametrize("B,T,H,D", FUSED)
def test_forward_plan_owns_every_row_once_within_the_card(B, T, H, D):
    plan = tfa.flash_fwd_plan(T, H, D)
    assert plan["route"] == "fused"
    _within_the_card(plan, "fwd", T, H, D)
    G, rs = plan["heads"], plan["dp"] + tfa.FT_PAD
    if plan["split"] == "keys":      # the q, k and v tiles
        assert plan["ld"] is None and plan["smem"] == 4 * G * T * 3 * rs
    else:                            # and the scores, an odd number a row
        assert plan["ld"] in (T, T + 1) and plan["ld"] % 2 == 1
        assert plan["smem"] == 4 * G * T * (3 * rs + plan["ld"])
    _owns_every_row_once(plan, B, T, H)
    assert tfa.flash_fwd_plan(T, H, D) is plan


def test_fused_plan_at_config4():
    gen = tfa.flash_bwd_plan(37, 8, 32)
    disc = tfa.flash_bwd_plan(36, 8, 16)
    # two heads a block: 256 blocks at B = 64, two or more a SM
    assert (gen["heads"], gen["threads"], gen["smem"]) == (2, 160, 65120)
    assert (disc["heads"], disc["threads"], disc["smem"]) == (2, 160, 44928)
    assert gen["ld"] == disc["ld"] == 38
    # the forward: two heads of the generator, four of the discriminator
    assert [tfa.flash_fwd_plan(37, 8, 32)[k] for k in ("heads", "threads",
                                                        "smem")] == [
        2, 160, 31968]
    assert [tfa.flash_fwd_plan(36, 8, 16)[k] for k in ("heads", "threads",
                                                        "smem")] == [
        4, 288, 34560]


def test_fused_plans_at_config5():
    """GPT-2's head dim 64 at the MLE pass's T = 37: two heads a forward
    block (384 blocks at B = 64, 3 an SM), one a backward block (768
    blocks, 4 an SM)."""
    fwd, bwd = tfa.flash_fwd_plan(37, 12, 64), tfa.flash_bwd_plan(37, 12, 64)
    assert fwd["split"] == bwd["split"] == "columns"
    assert (fwd["heads"], fwd["threads"], fwd["smem"]) == (2, 160, 71336)
    assert (bwd["heads"], bwd["threads"], bwd["smem"]) == (1, 96, 51208)
    assert fwd["ld"] == bwd["ld"] == 37
    assert 3 * fwd["smem"] <= SMEM_MAX and 4 * bwd["smem"] <= SMEM_MAX


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


@pytest.mark.parametrize("T", [1, 5, 9, 36, 37, 64])
def test_pair_writes_of_a_warp_fall_in_distinct_banks(T):
    """At D > 32, lanes (row r, half c) of a warp write word c of pair
    (r, j): 16 rows, 2 halves, 32 banks, for rows across a head's end
    too; the forward's lane 0 of each row writes 16 banks."""
    ld = tfa.flash_bwd_plan(T, 1, 64)["ld"]
    assert ld == tfa.flash_fwd_plan(T, 1, 64)["ld"]
    for r0 in (0, 16, max(T - 8, 0)):
        rows = np.arange(r0, r0 + 16)[:, None]
        for j in range(min(T, 3)):
            banks = (2 * (rows * ld + j) + np.arange(2)[None, :]) % 32
            assert len(np.unique(banks)) == 32
            assert len(np.unique((rows * ld + j) % 32)) == 16


@pytest.mark.parametrize("B,T,H,D", TILED + LONG)
def test_shapes_past_the_fused_kernel_go_tiled(B, T, H, D):
    """Past T = 64 or D = 64 both directions take the tiled route; the
    backward's plan is one launch of TB_THREADS threads a (b, h) within
    the card, its dQ sums and delta in shared memory exactly where the
    block then stays within its budget."""
    assert tfa.flash_fwd_plan(T, H, D) == {"route": "tiled"}
    plan = tfa.flash_bwd_plan(T, H, D)
    _tiled_within_the_card(plan, T, D)


def _tiled_within_the_card(plan, T, D):
    assert plan["route"] == "tiled" and plan["rows"] == tfa.TB_ROWS
    dp = plan["dp"]
    assert dp >= max(D, 16) and dp & (dp - 1) == 0 and dp < 2 * max(D, 16)
    most, budget = tfa.BUDGETS[("bwd", "tiled")]
    assert plan["threads"] == most == 128 <= THREADS_MAX
    rows = -(-T // tfa.TB_ROWS) * tfa.TB_ROWS
    assert plan["ws_floats"] == rows * (dp + 4) + rows
    # float32 staging (bfloat16's is smaller): q and dO twice, k, v; P, dS
    tiles = 6 * tfa.TB_ROWS * (dp + 4) * 4 + 2 * tfa.TB_ROWS * tfa.TB_PLD * 4
    shared = tiles + 4 * plan["ws_floats"] <= budget
    assert plan["ws"] == ("shared" if shared else "global")
    assert plan["smem"] == tiles + (4 * plan["ws_floats"] if shared else 0)
    assert plan["smem"] <= SMEM_MAX


@pytest.mark.parametrize("T", [65, 128, 129, 200, 513, 1024, 4096])
@pytest.mark.parametrize("D", [8, 16, 24, 32, 64, 72, 128, 256])
def test_tiled_plan_fits_the_card_at_any_length(T, D):
    _tiled_within_the_card(tfa.flash_bwd_plan(T, 8, D), T, D)


def _tiled_walk(T, length, causal):
    """The tiled kernel's steps for one (b, h), as it walks them: key tiles
    j below the length in order, for each the query tiles i from j
    (causal) or 0 to the last → ``[(j, i), ...]``."""
    nq = -(-T // tfa.TB_ROWS)
    nkv = -(-length // tfa.TB_ROWS)
    return [(j, i) for j in range(nkv) for i in range(j if causal else 0,
                                                      nq)]


@pytest.mark.parametrize("B,T,H,D", TILED + LONG)
@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_tiled_walk_covers_every_pair_row_and_chunk_once(B, T, H, D,
                                                         causal,
                                                         with_lengths):
    """Every valid (query, key) pair falls in exactly one step; every key
    row's dK and dV are written once (from its key tile's registers, or as
    zeros past the length), every query row's dQ once; each product's K
    (D in chunks of at most 32, or 32 queries or keys) is covered once."""
    n = tfa.TB_ROWS
    dp = tfa.flash_bwd_plan(T, H, D)["dp"]
    for length in ([0, 1, T // 2 + 1, T] if with_lengths else [T]):
        steps = _tiled_walk(T, length, causal)
        assert len(set(steps)) == len(steps)
        seen = np.zeros((T, T), np.int64)
        for j, i in steps:
            qi = np.arange(i * n, min(i * n + n, T))[:, None]
            kj = np.arange(j * n, min(j * n + n, T))[None, :]
            ok = (kj < length) & ((kj <= qi) if causal
                                  else np.ones_like(qi, bool))
            np.add.at(seen, (np.broadcast_to(qi, ok.shape)[ok],
                             np.broadcast_to(kj, ok.shape)[ok]), 1)
        i_, j_ = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        valid = (j_ < length) & ((j_ <= i_) if causal else True)
        assert (seen[valid] == 1).all() and (seen[~valid] == 0).all()
        nkv = -(-length // n)
        written = np.zeros(T, np.int64)
        for j in range(nkv):                         # the register stores
            written[j * n:min(j * n + n, T)] += 1
        written[nkv * n:] += 1                       # the zero fill
        assert (written == 1).all()
    kc = min(dp, 32)
    chunks = [(dc + kk, dc + kk + 8) for dc in range(0, dp, kc)
              for kk in range(0, kc, 8)]
    assert [c for c in chunks] == [(x, x + 8) for x in range(0, dp, 8)]
    assert D <= dp


@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_tiled_replay_matches_jax_gradients(causal, with_lengths):
    """The tiled kernel's walk replayed in float32 (delta from the stored
    out; per step S and dP, P masked before the exponential, dS; dV and dK
    summed per key tile, each step's dQ added into its rows in key-tile
    order) against the JAX package's gradients at T = 70 (three query
    tiles, the last of 6 rows) and D = 24 (a 32-column head dim)."""
    B, T, H, D = 2, 70, 2, 24
    assert tfa.flash_bwd_plan(T, H, D)["route"] == "tiled"
    rng = np.random.default_rng(170)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(F32)
                  for _ in range(4))
    lens = (np.array([0, 37], np.int32) if with_lengths else None)
    out, lse = _forward(q, k, v, lens, causal)
    got = _tiled_replay(q, k, v, out, g, lse, lens, causal)
    jl = None if lens is None else jnp.asarray(lens)
    want = jax.jit(jax.grad(
        lambda a, b_, c: jnp.sum(jfa.flash_attention(a, b_, c, causal, jl)
                                 * g), (0, 1, 2)))(q, k, v)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b_), err_msg=name, **GRAD)
    if with_lengths:
        for a in got:
            assert (a[0] == 0).all()


def _tiled_replay(q, k, v, out, dout, lse, lengths, causal):
    B, T, H, D = q.shape
    n, scale = tfa.TB_ROWS, F32(1.0 / math.sqrt(D))
    dq, dk, dv = (np.zeros_like(q) for _ in range(3))
    for b in range(B):
        length = T if lengths is None else min(max(int(lengths[b]), 0), T)
        for h in range(H):
            delta = np.einsum("td,td->t", dout[b, :, h], out[b, :, h],
                              dtype=F32)
            acc_q = np.zeros((T, D), F32)
            last_j = None
            dka = dva = None
            for j, i in _tiled_walk(T, length, causal):
                if j != last_j:
                    if last_j is not None:
                        ks = slice(last_j * n, min(last_j * n + n, T))
                        dk[b, ks, h], dv[b, ks, h] = dka * scale, dva
                    dka = np.zeros((min(j * n + n, T) - j * n, D), F32)
                    dva = np.zeros_like(dka)
                    last_j = j
                qs = slice(i * n, min(i * n + n, T))
                ks = slice(j * n, min(j * n + n, T))
                qi = np.arange(qs.start, qs.stop)[:, None]
                kj = np.arange(ks.start, ks.stop)[None, :]
                ok = (kj < length) & ((kj <= qi) if causal else True)
                s = (q[b, qs, h] @ k[b, ks, h].T).astype(F32)
                dp = (dout[b, qs, h] @ v[b, ks, h].T).astype(F32)
                p = np.where(ok, np.exp(np.where(ok, s * scale - lse[
                    b, qs, h][:, None], 0.0)), 0.0).astype(F32)
                ds = (p * (dp - delta[qs][:, None])).astype(F32)
                dva += (p.T @ dout[b, qs, h]).astype(F32)
                dka += (ds.T @ q[b, qs, h]).astype(F32)
                acc_q[qs] += (ds @ k[b, ks, h]).astype(F32)
            if last_j is not None:
                ks = slice(last_j * n, min(last_j * n + n, T))
                dk[b, ks, h], dv[b, ks, h] = dka * scale, dva
            dq[b, :, h] = acc_q * scale
    return dq, dk, dv


@pytest.mark.parametrize("T,H,D", [(0, 2, 8), (4, 0, 8), (4, 2, 12),
                                   (4, 2, 264), (4, 2, 0)])
def test_impossible_shapes_raise(T, H, D):
    for plan in PLANS.values():
        with pytest.raises(ValueError):
            plan(T, H, D)


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


def _dot_halves(a, b):
    """``dot_half`` on both column halves, then the shuffle's sum: half c
    holds float4 chunks c, c + 2, ... (columns 8m + 4c .. 8m + 4c + 3 for
    m < 8; pad columns past D add nothing), on chain m % 2."""
    halves = []
    for c in range(2):
        chains = [F32(0), F32(0)]
        for m in range(8):
            for col in range(8 * m + 4 * c, min(8 * m + 4 * c + 4, len(a))):
                chains[m % 2] = F32(chains[m % 2] + F32(a[col] * b[col]))
        halves.append(F32(chains[0] + chains[1]))
    return F32(halves[0] + halves[1])


def _replay_columns(q, k, v, out, dout, lse, lengths, causal, plan):
    """The column-half kernel's two phases, block by block and row by row
    in its order: phase 1 per (head, query row) every key ascending, the
    (p, ds) pairs written to the block's tile (NaN until written); phase
    2 per (head, key row) every query ascending, reading only what phase
    1 wrote.  A thread's columns of dq, dk and dv are one sum each."""
    B, T, H, D = q.shape
    G, ld = plan["heads"], plan["ld"]
    scale = F32(1.0 / math.sqrt(D))
    dq, dk, dv = (np.full(q.shape, np.nan, F32) for _ in range(3))
    groups = -(-H // G)
    for blk in range(B * groups):
        b, h0 = blk // groups, (blk % groups) * G
        gh = min(G, H - h0)
        length = T if lengths is None else min(max(int(lengths[b]), 0), T)
        pairs = np.full((gh * T, ld, 2), np.nan, F32)
        for r in range(gh * T):               # phase 1: query row i
            g, i = divmod(r, T)
            h = h0 + g
            nk = min(length, i + 1) if causal else length
            delta = _dot_halves(dout[b, i, h], out[b, i, h])
            acc = np.zeros(D, F32)
            for j in range(nk):
                sc = F32(_dot_halves(q[b, i, h], k[b, j, h]) * scale)
                dp = _dot_halves(dout[b, i, h], v[b, j, h])
                p = F32(np.exp(F32(sc - lse[b, i, h])))
                ds = F32(p * F32(dp - delta))
                acc = (acc + ds * k[b, j, h]).astype(F32)
                pairs[r, j] = p, ds
            dq[b, i, h] = acc * scale
        for r in range(gh * T):               # phase 2: key row j
            g, j = divmod(r, T)
            h = h0 + g
            dka, dva = np.zeros(D, F32), np.zeros(D, F32)
            if j < length:
                for i in range(j if causal else 0, T):
                    p, ds = pairs[g * T + i, j]
                    assert not (np.isnan(p) or np.isnan(ds)), (i, j)
                    dva = (dva + p * dout[b, i, h]).astype(F32)
                    dka = (dka + ds * q[b, i, h]).astype(F32)
            dk[b, j, h] = dka * scale
            dv[b, j, h] = dva
    return dq, dk, dv


def _replay(q, k, v, out, dout, lse, lengths, causal):
    """The fused kernel's two phases, block by block and thread by thread
    in its order (a thread's sums over its keys or queries ascending; the
    slices' partial rows joined in slice order)."""
    B, T, H, D = q.shape
    plan = tfa.flash_bwd_plan(T, H, D)
    if plan["split"] == "columns":
        return _replay_columns(q, k, v, out, dout, lse, lengths, causal,
                               plan)
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
    _check_replay(2, T, 2, 8, causal, with_lengths)


@pytest.mark.parametrize("causal,with_lengths", MASKS)
def test_column_half_replay_matches_jax_gradients(causal, with_lengths):
    """The D = 64 design, three heads (a block of two and one of one)."""
    assert tfa.flash_bwd_plan(7, 3, 64)["heads"] == 2
    _check_replay(2, 7, 3, 64, causal, with_lengths)


def _check_replay(B, T, H, D, causal, with_lengths):
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
