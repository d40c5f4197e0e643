"""The launch plans of the persistent decode and reverse BPTT kernels
(``kernels/decode_sample.py:persistent_plan``, ``kernels/lstm_bptt.py:
reverse_plan``): pure Python, so they are checked here on the CPU.  Every
hidden unit, vocabulary row and combine row is owned by exactly one
block; the shared memory stays within the limit passed in; the weights
stay resident at the preset widths on an H100's 132 SMs and are streamed
where they do not fit; a grid that cannot be co-resident raises."""

import pytest

from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import lstm_bptt

N_SM, SMEM = 132, 232448          # H100 SXM: SMs, opt-in bytes per block


def _owned_once(ranges, n):
    """Each of 0..n-1 in exactly one of the half-open ``ranges``."""
    seen = [0] * n
    for lo, hi in ranges:
        for i in range(lo, hi):
            seen[i] += 1
    return seen == [1] * n


# (B, E, H, V, nl): config3 / config2 widths at the bench's vocabulary,
# and the ragged edges: H not a multiple of the units per block, V not a
# multiple of the 64-row tile, B = 1, 33, 65
DECODE_SHAPES = [(64, 512, 512, 11008, 2), (8, 512, 512, 11008, 2),
                 (1, 48, 40, 300, 1), (33, 48, 42, 301, 3),
                 (65, 32, 700, 257, 1), (1, 16, 133, 65, 3),
                 (65, 512, 1000, 11009, 2)]


@pytest.mark.parametrize("B,E,H,V,nl", DECODE_SHAPES)
def test_decode_plan_owns_everything_once(B, E, H, V, nl):
    plan = ds.persistent_plan(B, E, H, V, nl, N_SM, SMEM)
    assert 1 <= plan["blocks"] <= N_SM
    assert len(plan["units"]) == plan["blocks"]
    assert _owned_once(plan["units"], H)
    assert all(hi - lo <= plan["units_per_block"] for lo, hi in plan["units"])
    rows = [r for tiles in plan["vocab_rows"] for r in tiles]
    assert _owned_once(rows, V)
    assert all(hi - lo <= 64 for lo, hi in rows)
    combine = sorted(b for rows_b in plan["batch_rows"] for b in rows_b)
    assert combine == list(range(B))
    assert plan["smem_bytes"] + ds.STATIC_SMEM <= SMEM
    assert plan["ints"] == (plan["blocks"], plan["units_per_block"],
                            int(plan["resident"]), plan["proj_batch_chunk"],
                            plan["smem_bytes"])
    assert plan["proj_batch_chunk"] >= min(B, 64)
    assert plan["barriers_per_step"] == nl + 2


@pytest.mark.parametrize("limit", [95_000, 120_000, 170_000, SMEM])
def test_decode_plan_stays_within_the_limit(limit):
    plan = ds.persistent_plan(64, 512, 512, 11008, 2, N_SM, limit)
    assert plan["smem_bytes"] + ds.STATIC_SMEM <= limit
    assert plan["resident"] == (limit == SMEM)


def test_decode_plan_resident_at_the_preset_widths():
    # config3 and config2: E = H = 512, two layers, 4 units a block
    for B in (1, 8, 64):
        plan = ds.persistent_plan(B, 512, 512, 11008, 2, N_SM, SMEM)
        assert plan["resident"] and plan["units_per_block"] == 4
        # 16 gate rows x (1024 + 4) floats x 2 layers, and the stage
        assert plan["smem_bytes"] == 4 * 2 * 16 * 1028 + ds.STAGE_BYTES
    # H = 1024, two layers: the slice does not fit, the weights stream
    plan = ds.persistent_plan(64, 512, 1024, 11008, 2, N_SM, SMEM)
    assert not plan["resident"]
    assert plan["smem_bytes"] == ds.STAGE_BYTES


def test_decode_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError, match="co-resident"):
        ds.persistent_plan(64, 512, 512, 11008, 2, N_SM, SMEM,
                           blocks=N_SM + 1)
    with pytest.raises(ValueError, match="units per block"):
        ds.persistent_plan(8, 64, 17 * N_SM, 300, 1, N_SM, SMEM)
    with pytest.raises(ValueError, match="layers"):
        ds.persistent_plan(8, 64, 64, 300, 9, N_SM, SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        ds.persistent_plan(8, 64, 64, 300, 1, N_SM, 20_000)
    with pytest.raises(ValueError, match="positive"):
        ds.persistent_plan(0, 64, 64, 300, 1, N_SM, SMEM)


@pytest.mark.parametrize("B,H", [(64, 512), (1, 40), (33, 130), (65, 1000),
                                 (8, 2048)])
def test_reverse_plan_owns_every_unit_once(B, H):
    plan = lstm_bptt.reverse_plan(B, H, N_SM, SMEM)
    assert 1 <= plan["blocks"] <= N_SM
    assert _owned_once(plan["units"], H)
    assert plan["smem_bytes"] + lstm_bptt.STATIC_SMEM <= SMEM
    assert plan["ints"] == (plan["blocks"], plan["units_per_block"],
                            int(plan["resident"]), plan["smem_bytes"])
    assert plan["barriers_per_step"] == 1


def test_reverse_plan_branches_and_limits():
    plan = lstm_bptt.reverse_plan(64, 512, N_SM, SMEM)
    # 4 units a block: 4 rows of w_hh [512, 2048] = 32 KB, and the carries
    assert plan["resident"] and plan["units_per_block"] == 4
    assert plan["smem_bytes"] == (lstm_bptt.STAGE_BYTES + 4 * 2 * 64 * 4
                                  + 4 * 4 * 2052)
    streamed = lstm_bptt.reverse_plan(8, 2048, N_SM, SMEM)
    assert not streamed["resident"]
    small = lstm_bptt.reverse_plan(64, 512, N_SM, 160_000)
    assert not small["resident"]
    assert small["smem_bytes"] + lstm_bptt.STATIC_SMEM <= 160_000
    with pytest.raises(ValueError, match="co-resident"):
        lstm_bptt.reverse_plan(64, 512, N_SM, SMEM, blocks=9 * N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        lstm_bptt.reverse_plan(4096, 512, N_SM, SMEM, blocks=32)
    with pytest.raises(ValueError, match="units per block"):
        lstm_bptt.reverse_plan(8, 17 * N_SM, N_SM, SMEM)
