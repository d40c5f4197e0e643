"""The launch plan of the conv banks' backward
(``kernels/disc_conv.py:conv_bwd_plan``): pure Python, so it is checked
here on the CPU.  Every (column, filter) of every bank falls in one
(column tile, slab) of one launch; the banks' groups, slabs and C ints are
laid out in order; every dW / db entry has one slot of a block's partial
row, which the reduction sums over the blocks in block order; config3 is
one launch and the reduction; what cannot run raises.  The kernels'
arithmetic is held against the plain versions on the card
(``tests/test_torch_port_disc_cuda.py``)."""

import pytest

from gan_image_captioning_tpu_torch.kernels import disc_conv

BANKS3 = ((300, 3), (300, 4), (300, 5))
TEN = tuple((3 + 7 * i, 1 + i % 5) for i in range(10))
CASES = [(64 * 64, 36, 1, BANKS3), (111, 5, 1, ((40, 5), (33, 2))),
         (10, 9, 2, ((8, 3), (70, 4))), (6, 7, 1, TEN)]


@pytest.mark.parametrize("Q,L,eds,banks", CASES)
def test_conv_bwd_plan_covers_every_pair_once(Q, L, eds, banks):
    plan = disc_conv.conv_bwd_plan(Q, L, eds, banks)
    cols = disc_conv.BW_COLS
    # column tiles: every column in one block, no block empty
    assert (plan["blocks"] - 1) * cols < Q <= plan["blocks"] * cols
    # every filter of every bank in one slab of one launch, banks in order
    seen, off = [], 0
    for g, launch in enumerate(plan["launches"]):
        assert launch["accumulate"] == (g > 0)
        assert 1 <= len(launch["banks"]) <= disc_conv.BW_MAX_BANKS
        slab = 0
        for b in launch["banks"]:
            assert (b["off"], b["slab0"]) == (off, slab)
            filters = [s * disc_conv.BW_SLAB + j
                       for s in range(b["slabs"])
                       for j in range(disc_conv.BW_SLAB)
                       if s * disc_conv.BW_SLAB + j < b["n"]]
            assert filters == list(range(b["n"]))
            assert (b["slabs"] - 1) * disc_conv.BW_SLAB < b["n"]
            seen.append((b["n"], b["f"]))
            slab += b["slabs"]
            off += b["n"]
        assert launch["slabs"] == slab
    assert tuple(seen) == tuple(banks)
    assert plan["slabs"] == sum(x["slabs"] for x in plan["launches"])
    assert len(plan["launches"]) == -(-len(banks) // disc_conv.BW_MAX_BANKS)
    assert plan["kernel_launches"] == len(plan["launches"]) + 1
    assert disc_conv.conv_bwd_plan(Q, L, eds, list(banks)) is plan  # cached


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("Q,L,eds,banks", [CASES[0], CASES[2], CASES[3]])
def test_conv_bwd_plan_sums_every_dw_slot_once(Q, L, eds, banks, raw):
    plan = disc_conv.conv_bwd_plan(Q, L, eds, banks, raw)
    F = sum(n for n, _ in banks)
    ldw = max(f for _, f in banks) * eds
    # a block's partial row: dW (k, g) at k·F + g, then db[g] at ldw·F + g
    slots = [k * F + g for k in range(ldw) for g in range(F)]
    if raw:
        slots += [ldw * F + g for g in range(F)]
    assert sorted(slots) == list(range(plan["slots"]))
    # the C call's ints: (n, f, first row, the gradient's row stride)
    assert plan["ints"] == [v for i, (n, f) in enumerate(banks) for v in (
        n, f, sum(m for m, _ in banks[:i]), F if raw else n)]
    assert disc_conv.conv_bwd_plan(Q, L, eds, banks, not raw) is not plan


def test_conv_bwd_plan_at_config3_is_one_launch():
    for raw in (False, True):
        plan = disc_conv.conv_bwd_plan(64 * 64, 36, 1, BANKS3, raw)
        (launch,) = plan["launches"]
        # 128 column tiles of 32; 5 slabs of 64 filters per bank of 300
        assert plan["blocks"] == 128 and plan["kernel_launches"] == 2
        assert [b["slab0"] for b in launch["banks"]] == [0, 5, 10]
        assert plan["slabs"] == 15 and not launch["accumulate"]
        assert plan["slots"] == 5 * 900 + (900 if raw else 0)


def test_conv_bwd_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError):                # filter past the rows
        disc_conv.conv_bwd_plan(8, 3, 1, ((4, 4),))
    with pytest.raises(ValueError):
        disc_conv.conv_bwd_plan(0, 36, 1, BANKS3)
    with pytest.raises(ValueError):
        disc_conv.conv_bwd_plan(8, 36, 1, ())
    with pytest.raises(ValueError):
        disc_conv.conv_bwd_plan(8, 36, 1, ((0, 3),))
    with pytest.raises(ValueError):
        disc_conv.conv_bwd_plan(8, 36, 0, BANKS3)
