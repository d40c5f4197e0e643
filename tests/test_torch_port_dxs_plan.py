"""The launch plan of the DXS backward (``kernels/disc_conv.py:
conv_dxs_plan``) and its wrappers on the CPU.  The plan is pure Python:
every column falls in one column tile; every (bank, tap) item lies in
exactly one segment of one launch, in order, with a bank's taps split only
where one launch cannot hold them; every dW and db slot of a block's
partial row is written by exactly one item, which the reduction then sums
over the blocks in order; config3 is one launch and the reduction; each
launch's shared memory is within the card's; the C call's ints are laid
out as ``csrc/disc_conv.cu:gic_conv_dxs`` reads them; what cannot run
raises.  On CPU tensors :func:`conv_bank_dxs_raw` is the plain version
(mask and db as ``_masked`` computes them) and counts no launch.  The
kernels' arithmetic is held against the plain versions on the card
(``tests/test_torch_port_disc_cuda.py``)."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import disc_conv

torch.set_num_threads(1)  # tiny ops: a thread a core costs more than it saves

BANKS3 = ((300, 3), (300, 4), (300, 5))
TEN = tuple((3 + 7 * i, 1 + i % 5) for i in range(10))
# (Q, L, eds, banks): config3, odd sizes, more banks than one launch holds,
# long rows (the items split over launches), eds 16 (a bank's taps split),
# one bank, one filter of one tap
CASES = [(64 * 64, 36, 1, BANKS3), (111, 5, 1, ((40, 5), (33, 2))),
         (10, 9, 2, ((8, 3), (70, 4))), (6, 7, 1, TEN),
         (39, 130, 1, ((70, 3), (33, 5))), (8, 36, 16, BANKS3),
         (33, 12, 4, ((65, 6),)), (1, 1, 1, ((1, 1),))]


def _items(plan):
    return [(s["bank"], k) for launch in plan["launches"]
            for s in launch["segments"] for k in range(s["k0"], s["k1"])]


@pytest.mark.parametrize("Q,L,eds,banks", CASES)
def test_conv_dxs_plan_covers_every_item_once(Q, L, eds, banks):
    plan = disc_conv.conv_dxs_plan(Q, L, eds, banks)
    cols = disc_conv.DX_COLS
    # column tiles: every column in one block, no block empty
    assert (plan["blocks"] - 1) * cols < Q <= plan["blocks"] * cols
    # every (bank, tap) in one segment of one launch, in order
    assert _items(plan) == [(b, k) for b, (_, f) in enumerate(banks)
                            for k in range(f * eds)]
    for launch in plan["launches"]:
        segs = launch["segments"]
        assert 1 <= len(segs) <= disc_conv.DX_MAX_SEGS
        # a bank once a launch; only the first segment continues a bank,
        # only the last one stops short of its taps
        assert len({s["bank"] for s in segs}) == len(segs)
        assert all(s["k0"] == 0 for s in segs[1:])
        assert all(s["k1"] == banks[s["bank"]][1] * eds for s in segs[:-1])
        items = sum(s["k1"] - s["k0"] for s in segs)
        assert launch["items"] == items
        assert launch["threads"] == 32 * min(disc_conv.DX_MAX_WARPS, items)
        assert launch["steps"] == max(-(-banks[s["bank"]][0]
                                        // disc_conv.DX_SLAB) for s in segs)
        assert launch["smem_bytes"] <= disc_conv.SMEM_LIMIT
        assert launch["ints"] == [len(segs), launch["smem_bytes"]] + [
            v for s in segs for v in (s["bank"], s["k0"], s["k1"])]
    assert plan["kernel_launches"] == len(plan["launches"]) + 1
    F = sum(n for n, _ in banks)
    assert plan["ints"] == [v for i, (n, f) in enumerate(banks) for v in (
        n, f, sum(m for m, _ in banks[:i]), F)]
    assert disc_conv.conv_dxs_plan(Q, L, eds, list(banks)) is plan


@pytest.mark.parametrize("Q,L,eds,banks", CASES)
def test_conv_dxs_plan_writes_every_dw_and_db_slot_once(Q, L, eds, banks):
    plan = disc_conv.conv_dxs_plan(Q, L, eds, banks)
    F = sum(n for n, _ in banks)
    ldw = max(f for _, f in banks) * eds
    offs = np.cumsum([0] + [n for n, _ in banks])
    written = np.zeros(plan["slots"], dtype=np.int64)
    # item (b, k) writes dW (k, g) of its bank's filters; tap 0 also the
    # zero taps past the bank's width and db
    for b, k in _items(plan):
        n, f = banks[b]
        g = np.arange(offs[b], offs[b] + n)
        written[k * F + g] += 1
        if k == 0:
            for kk in range(f * eds, ldw):
                written[kk * F + g] += 1
            written[ldw * F + g] += 1
    assert plan["slots"] == ldw * F + F
    np.testing.assert_array_equal(written, 1)


def test_conv_dxs_plan_at_config3_is_one_launch_and_a_reduction():
    plan = disc_conv.conv_dxs_plan(64 * 64, 36, 1, BANKS3)
    (launch,) = plan["launches"]
    # 128 column tiles of 32; the 12 (bank, tap) items a warp each; 10
    # steps of 32 filters of every bank
    assert plan["blocks"] == 128 and plan["kernel_launches"] == 2
    assert [(s["bank"], s["k0"], s["k1"]) for s in launch["segments"]] \
        == [(0, 0, 3), (1, 0, 4), (2, 0, 5)]
    assert launch["threads"] == 12 * 32 and launch["steps"] == 10


def test_conv_dxs_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError):                # filter past the rows
        disc_conv.conv_dxs_plan(8, 3, 1, ((4, 4),))
    with pytest.raises(ValueError):
        disc_conv.conv_dxs_plan(0, 36, 1, BANKS3)
    with pytest.raises(ValueError):
        disc_conv.conv_dxs_plan(8, 36, 1, ())
    with pytest.raises(ValueError):
        disc_conv.conv_dxs_plan(8, 36, 1, ((0, 3),))
    with pytest.raises(ValueError):                # one tap's rows too many
        disc_conv.conv_dxs_plan(8, 2000, 1, ((4, 3),))


def _bank_inputs(B=3, L=9, R=5, eds=2, banks=((8, 3), (6, 4)), seed=0):
    rng = np.random.default_rng(seed)
    maxf = max(f for _, f in banks)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    convs = [(t(n, 1, f, eds, scale=f ** -0.5), t(n, scale=0.1))
             for n, f in banks]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, eds)
    emb_pad = torch.nn.functional.pad(t(B, L, R * eds),
                                      (0, 0, 0, maxf - 1)).contiguous()
    pooled, idxs = disc_conv.conv_relu_maxpool_plain(emb_pad, w_all, b_all,
                                                     banks, R, eds)
    return emb_pad, w_all.contiguous(), banks, R, eds, pooled, idxs, t(
        *pooled.shape)


def test_dxs_raw_on_the_cpu_is_the_masked_plain_version():
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _bank_inputs()
    before = disc_conv.conv_bank_dxs.launches
    dxss, dw, db = disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds,
                                               pooled, idxs, d_pooled)
    assert disc_conv.conv_bank_dxs.launches == before  # the CPU runs no kernel
    dpms, want_db = disc_conv._masked(pooled, d_pooled, banks)
    want_dxss, want_dw = disc_conv.conv_dxs_plain(emb_pad, w_all, banks, R,
                                                  eds, idxs, dpms)
    for a, b in zip(dxss, want_dxss):
        assert torch.equal(a, b)
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)
    with pytest.raises(ValueError):
        disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds,
                                    pooled[:, :2], idxs, d_pooled)
    with pytest.raises(TypeError):
        disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds, pooled,
                                    [i.long() for i in idxs], d_pooled)


def test_mxu_dxs_autograd_route_matches_the_plain_route_on_the_cpu():
    emb_pad, w_all, banks, R, eds, _, _, _ = _bank_inputs(seed=1)
    b_all = torch.from_numpy(np.random.default_rng(2).standard_normal(
        w_all.shape[0]).astype(np.float32) * 0.1)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (emb_pad.shape[0], R, w_all.shape[0])).astype(np.float32))

    def grads(engine):
        leaves = [x.clone().requires_grad_(True)
                  for x in (emb_pad, w_all, b_all)]
        out = disc_conv.conv_relu_maxpool(*leaves, banks, R, eds, engine)
        return torch.autograd.grad(out, leaves, g)

    for a, b in zip(grads("mxu_dxs"), grads("plain")):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
