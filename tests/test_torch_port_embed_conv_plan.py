"""The launch plans of the fused-embed backward and the conv-bank forward
(``kernels/decode_sample.py:embed_bwd_plan``,
``kernels/disc_conv.py:conv_fwd_plan``): pure Python, so they are checked
here on the CPU.

The embed backward's plan splits the sums over V of two products (se and
d_htop), in float32 by the float32 kernels' tiles and in bfloat16 by the
bfloat16 ones': every V index falls in exactly one split, each chunk whole
K tiles, the bfloat16 column sums cover every row once, and the scratch
holds what the C side lays out in it (the tiles' shared memory is checked
where they are defined, by static_asserts in ``csrc/decode_embed_bwd.cu``
against the 227 KB a block may use).  The conv forward's block map repeats the
kernel's index arithmetic (``csrc/disc_conv.cu:conv_fwd_kernel``: the bank
from blockIdx.y and the banks' first tiles): every (column, filter) of
every bank is owned by one thread; shared memory stays under an H100's
227 KB.  config3 and the edge shapes get the grids the kernels expect;
what cannot run raises."""

import numpy as np
import pytest

from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import disc_conv

N_SM, SMEM = 132, 232448          # H100 SXM: SMs, opt-in bytes per block
CONFIG3 = dict(R=36 * 64, H=512, V=11008, Ed=64)
BANKS3 = ((300, 3), (300, 4), (300, 5))


def _check_split(p, M, N, K, tile):
    bm, bn, bk = tile
    assert p["tiles"] == -(-M // bm) * -(-N // bn)
    assert 1 <= p["splits"] <= ds.EB_MAX_SPLIT
    # K: every index in exactly one split, each chunk whole K tiles
    assert p["chunk"] % bk == 0
    owner = np.zeros(K, dtype=np.int64)
    for s in range(p["splits"]):
        assert s * p["chunk"] < K
        owner[s * p["chunk"]:(s + 1) * p["chunk"]] += 1
    assert (owner == 1).all()


@pytest.mark.parametrize("R,H,V,Ed", [
    (36 * 64, 512, 11008, 64),     # config3
    (15, 40, 300, 20),             # under one tile everywhere
    (198, 70, 1300, 70),           # no dimension a multiple of a tile
    (1, 1, 1, 1),
    (36 * 64, 1024, 30000, 128),   # a wider model
])
def test_embed_bwd_plan_covers_every_output_and_k_once(R, H, V, Ed):
    plan = ds.embed_bwd_plan(R, H, V, Ed, N_SM)
    _check_split(plan["se"], R, Ed, V, ds.EB_SE_TILE)
    _check_split(plan["d_htop"], R, H, V, ds.EB_HTOP_TILE)
    s0, c0, s3, c3, scratch = plan["ints"]
    assert (s0, c0) == (plan["se"]["splits"], plan["se"]["chunk"])
    assert (s3, c3) == (plan["d_htop"]["splits"], plan["d_htop"]["chunk"])
    pad = lambda n: -(-n // 4) * 4  # noqa: E731
    assert scratch == plan["scratch_floats"] == pad(R * V) + pad(R) + pad(
        s0 * R * Ed) + (s3 * R * H if s3 > 1 else 0)
    assert plan["launches"] == 5 + (s3 > 1)
    assert ds.embed_bwd_plan(R, H, V, Ed, N_SM) is plan     # cached


@pytest.mark.parametrize("R,H,V,Ed", [
    (36 * 64, 512, 11008, 64),     # config3
    (15, 40, 300, 20),             # under one tile everywhere
    (198, 70, 1300, 70),           # no dimension a multiple of a tile
    (65, 200, 1544, 72),           # aligned rows, ragged tiles
    (1, 1, 1, 1),
    (36 * 64, 1024, 30000, 128),   # a wider model
])
def test_embed_bwd_bf16_plan_covers_every_output_and_k_once(R, H, V, Ed):
    """The bfloat16 plan: the splits of its own tiles (se two blocks an
    SM, d_htop's wgmma blocks of 128 x 256) cover V once in whole K tiles
    of 64; six launches; the d_logits pass's column-sum tiles of
    EB_DL_ROWS rows cover every row once (dbp sums them in order); the
    scratch holds dl, inner, the se partials, the column sums and the
    d_htop partials."""
    plan = ds.embed_bwd_plan(R, H, V, Ed, N_SM, True)
    (se_tile, se_per_sm), (ht_tile, ht_per_sm) = (
        ds.EB_BF16_TILES["se"], ds.EB_BF16_TILES["d_htop"])
    assert (se_per_sm, ht_per_sm) == (2, 1)
    _check_split(plan["se"], R, Ed, V, se_tile)
    _check_split(plan["d_htop"], R, H, V, ht_tile)
    # one wave of blocks a product (or one split where the tiles exceed it)
    for name, per_sm in (("se", se_per_sm), ("d_htop", ht_per_sm)):
        p = plan[name]
        assert p["splits"] == 1 or p["tiles"] * p["splits"] <= N_SM * per_sm
    # the C side's K tiles of 32 (se's split check) and 64 (d_htop's)
    assert plan["se"]["chunk"] % ds.EB_SE_TILE[2] == 0
    assert plan["d_htop"]["chunk"] % ds.EB_HTOP_TILE[2] == 0
    rows = np.zeros(R, dtype=np.int64)
    for t in range(-(-R // ds.EB_DL_ROWS)):
        rows[t * ds.EB_DL_ROWS:(t + 1) * ds.EB_DL_ROWS] += 1
    assert (rows == 1).all()
    s0, c0, s3, c3, scratch = plan["ints"]
    pad = lambda n: -(-n // 4) * 4  # noqa: E731
    assert scratch == plan["scratch_floats"] == (
        pad(-(-R * V // 2)) + pad(R) + pad(s0 * R * Ed)
        + pad(-(-R // ds.EB_DL_ROWS) * V) + s3 * R * H)
    assert plan["launches"] == 6
    assert ds.embed_bwd_plan(R, H, V, Ed, N_SM, True) is plan


def test_embed_bwd_bf16_plan_at_config3():
    """One wave of blocks each: se's 18 tiles split 14 ways (13 K tiles of
    64 a chunk) on 264 slots (two blocks an SM), 252 blocks; d_htop's 18 x
    2 wgmma tiles 3 ways (58 K tiles of 64), 108 blocks on 132 SMs."""
    plan = ds.embed_bwd_plan(**CONFIG3, n_sm=N_SM, bf16=True)
    se, d_htop = plan["se"], plan["d_htop"]
    assert (se["tiles"], se["splits"], se["chunk"]) == (18, 14, 832)
    assert (d_htop["tiles"], d_htop["splits"], d_htop["chunk"]) == (36, 3,
                                                                    3712)
    assert se["tiles"] * se["splits"] <= 2 * N_SM
    assert d_htop["tiles"] * d_htop["splits"] <= N_SM
    assert plan["ints"][:4] == (14, 832, 3, 3712)


def test_embed_bwd_plan_at_config3():
    plan = ds.embed_bwd_plan(**CONFIG3, n_sm=N_SM)
    # d_htop's 18 x 4 tiles split 11 ways over V (16 K tiles of 64 a
    # chunk): 792 blocks, 6 full waves of 132; se's 18 tiles 22 ways (16 K
    # tiles of 32): 3 waves
    d_htop, se = plan["d_htop"], plan["se"]
    assert (d_htop["tiles"], d_htop["splits"], d_htop["chunk"]) == (72, 11,
                                                                    1024)
    assert d_htop["tiles"] * d_htop["splits"] == 6 * N_SM
    assert (se["tiles"], se["splits"], se["chunk"]) == (18, 22, 512)
    assert se["tiles"] * se["splits"] == 3 * N_SM
    assert plan["ints"] == (22, 512, 11, 1024, plan["scratch_floats"])
    assert plan["launches"] == 6
    # d_logits [R, V] is the bulk of the scratch
    assert plan["scratch_floats"] * 4 < 1.7 * 2304 * 11008 * 4


@pytest.mark.parametrize("n_sm", [1, 8, 132])
def test_embed_bwd_split_is_no_worse_than_none(n_sm):
    tiles, K = 72, 11008
    splits, chunk = ds._split_k(tiles, K, 64, n_sm)
    k_tiles = -(-K // 64)
    cost = -(-tiles * splits // n_sm) * (chunk // 64)
    assert cost <= -(-tiles // n_sm) * k_tiles
    assert 1 <= splits <= ds.EB_MAX_SPLIT


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_bwd_plan_refuses_empty_shapes(bf16):
    with pytest.raises(ValueError):
        ds.embed_bwd_plan(0, 512, 11008, 64, N_SM, bf16)
    with pytest.raises(ValueError):
        ds.embed_bwd_plan(2304, 512, 11008, 64, 0, bf16)


def _conv_outputs(plan, Q):
    """How many threads write each (bank, column, filter), as
    conv_fwd_kernel maps blockIdx and threadIdx: an array [banks, Q,
    max n]."""
    banks_all = [b for launch in plan["launches"] for b in launch["banks"]]
    count = np.zeros((len(banks_all), Q, max(b["n"] for b in banks_all)),
                     dtype=np.int64)
    tid = np.arange(plan["threads"])
    fg, qi = tid % 16, tid // 16
    bank0 = 0
    for launch in plan["launches"]:
        banks = launch["banks"]
        gx, gy = launch["grid"]
        q = np.arange(gx)[:, None] * disc_conv.FW_QB + qi[None, :]
        for by in range(gy):
            b = 0
            while b + 1 < len(banks) and by >= banks[b + 1]["tile0"]:
                b += 1
            n0 = (by - banks[b]["tile0"]) * disc_conv.FW_NB
            for j in range(4):
                nn = np.broadcast_to(n0 + fg * 4 + j, q.shape)
                keep = (q < Q) & (nn < banks[b]["n"])
                np.add.at(count[bank0 + b], (q[keep], nn[keep]), 1)
        bank0 += len(banks)
    return count


@pytest.mark.parametrize("Q,L,eds,banks", [
    (64 * 64, 36, 1, BANKS3),                      # config3
    (18, 9, 1, ((70, 2), (33, 4))),                # n and Q off the tiles
    (35, 7, 2, ((5, 2), (64, 3), (65, 5))),        # 4-10 taps, eds 2
    (17, 12, 3, ((9, 2), (130, 4))),               # 6 and 12 taps
    (5, 6, 1, tuple((3 + i, 1 + i % 5) for i in range(11))),  # 2 launches
])
def test_conv_fwd_plan_covers_every_output_once(Q, L, eds, banks):
    plan = disc_conv.conv_fwd_plan(Q, L, eds, banks)
    assert plan["threads"] == 256
    count = _conv_outputs(plan, Q)
    for b, (n, _) in enumerate(banks):
        assert (count[b, :, :n] == 1).all() and (count[b, :, n:] == 0).all()
    off = 0
    for launch in plan["launches"]:
        assert len(launch["banks"]) <= disc_conv.FW_MAX_BANKS
        assert launch["smem_bytes"] <= SMEM
        assert launch["grid"][0] == -(-Q // disc_conv.FW_QB)
        tile, shared_taps = 0, 0
        for b in launch["banks"]:
            assert (b["off"], b["tile0"]) == (off, tile)
            assert b["registers"] == (b["f"] * eds <= disc_conv.FW_MAXT)
            if not b["registers"]:
                shared_taps = max(shared_taps, b["f"] * eds)
            tile += b["tiles"]
            off += b["n"]
        assert launch["grid"][1] == tile
        assert launch["smem_bytes"] == 4 * (
            disc_conv.FW_QB * ((L * eds) | 1) + shared_taps * disc_conv.FW_NB)
        assert launch["ints"] == [v for b in launch["banks"] for v in (
            b["n"], b["f"], b["off"], b["tile0"])]
    assert len(plan["launches"]) == -(-len(banks) // disc_conv.FW_MAX_BANKS)
    assert disc_conv.conv_fwd_plan(Q, L, eds, list(banks)) is plan  # cached


def test_conv_fwd_plan_at_config3_is_one_launch():
    plan = disc_conv.conv_fwd_plan(64 * 64, 36, 1, BANKS3)
    (launch,) = plan["launches"]
    # 256 column tiles of 16; 5 filter tiles of 64 per bank of 300
    assert launch["grid"] == (256, 15)
    assert [b["tile0"] for b in launch["banks"]] == [0, 5, 10]
    assert all(b["registers"] for b in launch["banks"])
    assert launch["smem_bytes"] == 4 * 16 * 37


def test_conv_fwd_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError):                # filter past the rows
        disc_conv.conv_fwd_plan(8, 3, 1, ((4, 4),))
    with pytest.raises(ValueError):                # rows past the smem
        disc_conv.conv_fwd_plan(8, 4000, 1, BANKS3)
    with pytest.raises(ValueError):
        disc_conv.conv_fwd_plan(0, 36, 1, BANKS3)
