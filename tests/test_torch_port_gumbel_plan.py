"""The launch plan of the fused Gumbel sampler
(``kernels/gumbel_sample.py:gumbel_plan``): pure Python, so it is checked
here on the CPU.  The kernel's own map from (CTA, thread, group, lane of
the group) to a column, as ``csrc/gumbel_sample.cu:col_of`` computes it, is
replayed with numpy: every (row, column) is covered exactly once, no CTA is
empty, a cluster holds at most 8 CTAs, the number of rows sets its size,
small V takes a warp per row and no cluster, and what cannot run raises.
The kernel's arithmetic is held against the plain version on the card
(``tests/test_torch_port_tf_cuda.py``)."""

import numpy as np
import pytest

from gan_image_captioning_tpu_torch.kernels import gumbel_sample as gs

# config4's sampler, the histogram's rows, the card tests' shapes (V not a
# multiple of 4, GPT-2's vocabulary, one row), tiny rows
SHAPES = [(64, 11008), (262144, 16), (1, 11008), (256, 11008), (4096, 16),
          (3, 50257), (64, 11007), (4, 300), (5, 257), (2, 5), (1, 1025),
          (7, 131072)]


def _columns(plan, V):
    """Per CTA of one row, the columns its threads take (in thread, group,
    lane-of-group order), as the kernel maps them."""
    nt, vecs, chunk = plan["threads"], plan["vecs"], plan["chunk"]
    if plan["mode"] == "rows":
        nt, ranks = 32, 1            # a warp per row, over the whole row
    else:
        ranks = plan["cluster"]
    i, j, t = np.meshgrid(np.arange(vecs), np.arange(4), np.arange(nt),
                          indexing="ij")
    out = []
    for r in range(ranks):
        c0, c1 = r * chunk, min(V, (r + 1) * chunk)
        col = (c0 + 4 * (i * nt + t) + j if plan["vec4"]
               else c0 + (4 * i + j) * nt + t).ravel()
        out.append(col[col < c1])
    return out


@pytest.mark.parametrize("B,V", SHAPES)
def test_gumbel_plan_covers_every_column_once(B, V):
    plan = gs.gumbel_plan(B, V)
    assert 1 <= plan["cluster"] <= gs.G_MAX_CLUSTER
    assert plan["vecs"] in (1, 2, 4, 8) and plan["threads"] % 32 == 0
    assert plan["vec4"] == (V % 4 == 0)
    cols = _columns(plan, V)
    assert all(len(c) > 0 for c in cols)                 # no empty CTA
    every = np.sort(np.concatenate(cols))
    np.testing.assert_array_equal(every, np.arange(V))   # each column once
    if plan["mode"] == "rows":
        # a warp per row: the CTAs' warps cover every row once
        assert plan["rows"] == plan["threads"] // 32
        assert (plan["ctas"] - 1) * plan["rows"] < B <= (plan["ctas"]
                                                         * plan["rows"])
    else:
        assert plan["rows"] == 1 and plan["ctas"] == B * plan["cluster"]
        # a thread's groups: the last one may lie past the slice, not more
        per_cta = plan["chunk"] // 4
        assert plan["vecs"] * plan["threads"] >= per_cta
        assert plan["chunk"] % 4 == 0
    assert gs.gumbel_plan(B, V) is plan                  # cached


def test_gumbel_plan_small_v_takes_a_warp_per_row_and_no_cluster():
    for B in (1, 7, 4096, 262144):
        plan = gs.gumbel_plan(B, 16)
        assert plan["cluster"] == 1 and plan["mode"] == "rows"
        assert plan["rows"] > 1 and plan["ctas"] == -(-B // plan["rows"])
    # the histogram's 2^18 rows: 32768 CTAs of 8 rows, not 2^18 clusters
    assert gs.gumbel_plan(1 << 18, 16)["ctas"] == 1 << 15


def test_gumbel_plan_at_config4_fills_the_card():
    plan = gs.gumbel_plan(64, 11008)
    # 64 rows of 2 CTAs: 128 CTAs over 132 SMs, each 5504 columns in 16-byte
    # groups, up to 8 groups a thread (6 of them in the slice)
    assert (plan["cluster"], plan["ctas"], plan["chunk"]) == (2, 128, 5504)
    assert (plan["threads"], plan["vecs"]) == (256, 8)
    # the number of rows sets the cluster: one row 8 CTAs, 32 rows 4, 128
    # rows and more one, each slice covered once
    for B, cluster in ((1, 8), (32, 4), (64, 2), (128, 1), (4096, 1)):
        other = gs.gumbel_plan(B, 11008)
        assert (other["cluster"], other["ctas"]) == (cluster, B * cluster)
        assert np.array_equal(np.sort(np.concatenate(_columns(other, 11008))),
                              np.arange(11008))


def test_gumbel_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError):
        gs.gumbel_plan(0, 16)
    with pytest.raises(ValueError):
        gs.gumbel_plan(4, 0)
    with pytest.raises(ValueError):                      # a row past registers
        gs.gumbel_plan(1, gs.G_V_MAX + 4)
    assert gs.gumbel_plan(1, gs.G_V_MAX)["vecs"] == gs.G_VPT_MAX


@pytest.mark.parametrize("B,V", SHAPES)
def test_bf16_vector_groups_are_whole_8_byte_words(B, V):
    """bfloat16 logits and soft take the same plan as float32: a vector
    group is 4 neighbouring columns, one 16-byte access of float32 and one
    8-byte access of bfloat16, so the vector path asks, in either dtype,
    that every group start at a multiple of 4 elements of the [B, V]
    array (V % 4 == 0 and slices cut at multiples of 4); [64, 11007]
    takes the scalar path in both."""
    plan = gs.gumbel_plan(B, V)
    assert plan["vec4"] == (V % 4 == 0)
    if not plan["vec4"]:
        return
    assert plan["chunk"] % 4 == 0
    nt = 32 if plan["mode"] == "rows" else plan["threads"]
    ranks = 1 if plan["mode"] == "rows" else plan["cluster"]
    i, t = np.meshgrid(np.arange(plan["vecs"]), np.arange(nt), indexing="ij")
    for r in range(ranks):
        starts = (r * plan["chunk"] + 4 * (i * nt + t)).ravel()
        for b in (0, B - 1):
            assert np.all((2 * (b * V + starts)) % 8 == 0)    # bfloat16
            assert np.all((4 * (b * V + starts)) % 16 == 0)   # float32
