"""The launch plans of the persistent BPTT chain and quantized serve
kernels (``kernels/lstm_bptt.py:chain_plan``,
``kernels/decode_sample.py:persistent_plan(..., quantized=True)``), and a
plain-torch model of how the quantized kernel reads its weights: pure
Python, so they are checked here on the CPU.

Every hidden unit and vocabulary row is owned by exactly one block; the
shared memory stays within the limit passed in; the weights stay resident
at config3 widths on an H100's 132 SMs / 227 KB and are streamed where
they do not fit; the chain runs a batch whose carries do not fit in
chunks, and a wide layer in passes, so it runs at any batch and width;
what cannot run raises.  The model repeats the kernel's
index arithmetic (``csrc/decode_serve.cu``: ``qval`` / ``qgate`` of the
dequantize-once prologue, the projection's byte ring, the embedding row
of the row combine) on the packed payloads and must give, bit for bit,
the weights of ``dequantized_decoder``, which the dense kernel reads."""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import lstm_bptt
from gan_image_captioning_tpu_torch.ops.quantize import (
    quantize, quantize_packed_int4)

N_SM, SMEM = 132, 232448          # H100 SXM: SMs, opt-in bytes per block
V3 = 11008


def _owned_once(ranges, n):
    seen = [0] * n
    for lo, hi in ranges:
        for i in range(lo, hi):
            seen[i] += 1
    return seen == [1] * n


@pytest.mark.parametrize("NL", [1, 2, 3])
@pytest.mark.parametrize("H", [512, 1024])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_plans_own_every_unit_and_tile_once(B, H, NL):
    plan = lstm_bptt.chain_plan(B, H, NL, N_SM, SMEM)
    upb = plan["units_per_block"]
    assert upb in (1, 2, 4, 8) and 1 <= plan["blocks"] <= N_SM
    assert _owned_once(plan["units"], H)
    assert all(hi - lo <= upb for lo, hi in plan["units"])
    assert plan["smem_bytes"] + lstm_bptt.STATIC_SMEM <= SMEM
    assert plan["barriers_per_step"] == NL
    assert plan["batch_chunk"] == B
    assert plan["ints"] == (plan["blocks"], upb, int(plan["resident"]),
                            plan["smem_bytes"], B)
    q = ds.persistent_plan(B, 512, H, V3, NL, N_SM, SMEM, quantized=True)
    assert _owned_once(q["units"], H)
    assert _owned_once([r for tiles in q["vocab_rows"] for r in tiles], V3)
    assert q["smem_bytes"] + ds.STATIC_SMEM <= SMEM
    dense = ds.persistent_plan(B, 512, H, V3, NL, N_SM, SMEM)
    assert q["resident"] == dense["resident"] or not q["resident"]
    assert q["smem_bytes"] - ds.RING_BYTES == (
        dense["smem_bytes"] if q["resident"] == dense["resident"]
        else ds.STAGE_BYTES)


def test_plans_pin_the_resident_branch_at_config3():
    plan = lstm_bptt.chain_plan(64, 512, 2, N_SM, SMEM)
    # 4 units a block: 3 slices (w_hh of both layers, w_ih of layer 1) of
    # 4 rows x (2048 + 4) floats, beside the 3-slot pool and the carries
    # dh, dc of both layers and dx_upper
    assert plan["resident"] and plan["batch_chunk"] == 64
    assert plan["units_per_block"] == 4 and plan["blocks"] == 128
    assert plan["smem_bytes"] == (lstm_bptt.CHAIN_STAGE_BYTES
                                  + 4 * 3 * 4 * 2052 + 4 * 5 * 64 * 4)
    # three layers or H = 1024: the weight rows are streamed
    assert not lstm_bptt.chain_plan(64, 512, 3, N_SM, SMEM)["resident"]
    wide = lstm_bptt.chain_plan(64, 1024, 2, N_SM, SMEM)
    assert not wide["resident"] and wide["units_per_block"] == 8
    for B in (1, 8, 64):
        q = ds.persistent_plan(B, 512, 512, V3, 2, N_SM, SMEM,
                               quantized=True)
        assert q["resident"] and q["units_per_block"] == 4
        # the dense kernel's slice and stage, and the projection's ring
        assert q["smem_bytes"] == (4 * 2 * 16 * 1028 + ds.STAGE_BYTES
                                   + ds.RING_BYTES)


# 128 bytes short of the resident rows beside 64 rows' carries (streamed),
# just enough, and 20 rows' carries more (resident, the whole batch)
@pytest.mark.parametrize("limit", [218_560, 218_688, 220_288])
def test_chain_plan_stays_within_the_limit(limit):
    plan = lstm_bptt.chain_plan(80, 512, 2, N_SM, limit)
    assert plan["smem_bytes"] + lstm_bptt.STATIC_SMEM <= limit
    assert plan["resident"] == (limit >= 218_688)
    assert plan["batch_chunk"] == (64 if limit == 218_688 else 80)
    rows = 4 * 3 * 4 * 2052 if plan["resident"] else 0
    assert plan["smem_bytes"] == (lstm_bptt.CHAIN_STAGE_BYTES + rows
                                  + 4 * 5 * 4 * plan["batch_chunk"])


@pytest.mark.parametrize("B,H,NL,upb,resident,chunk", [
    (1024, 512, 2, 4, True, 236),       # config3 rows, 5 chunks of rows
    (4096, 512, 2, 4, True, 236),
    (600, 1024, 3, 8, False, 524),
    (8, 2048, 2, 16, False, 8),         # 16 units: two passes of 8 rows
    (8, 9 * N_SM, 2, 16, False, 8),
    (64, 4096, 2, 32, False, 64)])
def test_chain_plan_runs_any_batch_and_width(B, H, NL, upb, resident,
                                             chunk):
    plan = lstm_bptt.chain_plan(B, H, NL, N_SM, SMEM)
    assert (plan["units_per_block"], plan["resident"],
            plan["batch_chunk"]) == (upb, resident, chunk)
    assert plan["blocks"] <= N_SM and _owned_once(plan["units"], H)
    assert plan["smem_bytes"] + lstm_bptt.STATIC_SMEM <= SMEM


def test_plans_refuse_what_cannot_run():
    with pytest.raises(ValueError, match="co-resident"):
        lstm_bptt.chain_plan(64, 512, 2, N_SM, SMEM, blocks=N_SM + 1)
    with pytest.raises(ValueError, match="shared memory"):
        lstm_bptt.chain_plan(64, 512, 2, N_SM, 115_100)
    with pytest.raises(ValueError, match="positive"):
        lstm_bptt.chain_plan(8, 512, 0, N_SM, SMEM)
    with pytest.raises(ValueError, match="positive"):
        lstm_bptt.chain_plan(8, 512, 2, N_SM, SMEM, blocks=0)
    with pytest.raises(ValueError, match="shared memory"):
        ds.persistent_plan(8, 64, 64, 300, 1, N_SM, 78_000, quantized=True)
    # the dense plan fits where the quantized one (with its ring) does not
    ds.persistent_plan(8, 64, 64, 300, 1, N_SM, 78_000)
    with pytest.raises(ValueError, match="co-resident"):
        ds.persistent_plan(8, 512, 512, V3, 2, N_SM, SMEM, blocks=N_SM + 1,
                           quantized=True)


# ------------------------------------------- the quantized kernel's reads

def _qval(q, bits, R, k, n):
    """``qval`` of the kernel: element (k, n) of an int8 payload, or of a
    packed int4 one with R byte rows, as a Python int."""
    if bits == 8:
        return int(q[k, n])
    if k < R:
        return ((int(q[k, n]) & 0x0F) ^ 8) - 8
    return int(q[k - R, n]) >> 4


def _deq(v, scale):
    """float(q) * scale, one float32 rounding (``__fmul_rn``)."""
    return (torch.tensor(float(v), dtype=torch.float32)
            * scale.to(torch.float32))


def _qdec(E, H, V, nl, bits, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if bits == 8:
        qfn = qemb = lambda w: quantize(w, bits=8)  # noqa: E731
    else:
        qfn = quantize_packed_int4

        def qemb(w):
            return quantize_packed_int4(w, pad_odd=True)
    return {"embed": qemb(t(V, E)),
            "lstm_q": [{"w": qfn(t((E if l == 0 else H) + H, 4 * H)),
                        "b": t(4 * H)} for l in range(nl)],
            "linear": {"w": qfn(t(H, V)), "b": t(V)}}


def _pad4(k):
    return -(-k // 4) * 4


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_once_prologue_is_dequantized_decoder(bits):
    # E = 6, H = 8: layer 0 packs In + H = 14 rows into R = 7 (odd) byte
    # rows; V = 13 (odd): the packed embedding's one pad row
    E, H, V, nl = 6, 8, 13, 2
    qdec = _qdec(E, H, V, nl, bits)
    layers, w_proj, _, embed = ds.dequantized_decoder(qdec, bits)
    plan = ds.persistent_plan(2, E, H, V, nl, 3, SMEM, quantized=True)
    upb = plan["units_per_block"]
    for blk, (j0, _) in enumerate(plan["units"]):
        for l, lq in enumerate(qdec["lstm_q"]):
            In = E if l == 0 else H
            wa = _pad4(In)
            ws = ds._kpad(wa + _pad4(H)) + 4
            q, scale = lq["w"].q, lq["w"].scale.reshape(-1)
            R = (In + H) // 2
            for r in range(4 * upb):
                g, j = r // upb, j0 + r % upb
                if j >= H:
                    continue
                n = g * H + j          # the gate row's column of Wq
                row = torch.zeros(ws)
                for k in range(ws):
                    if k < In:
                        kk = k
                    elif wa <= k < wa + H:
                        kk = In + k - wa
                    else:
                        continue
                    row[k] = _deq(_qval(q, bits, R, kk, n), scale[n])
                want = torch.zeros(ws)
                want[:In] = layers[l]["w_ih"][n]
                want[wa:wa + H] = layers[l]["w_hh"][n]
                assert torch.equal(row, want), (blk, l, r)
    # the projection's ring: byte row k (or k - H/2), column v
    pq, ps = qdec["linear"]["w"].q, qdec["linear"]["w"].scale.reshape(-1)
    R = H // 2 if bits == 4 else H
    got = torch.tensor([[float(_deq(_qval(pq, bits, R, k, v), ps[v]))
                         for k in range(H)] for v in range(V)])
    assert torch.equal(got, w_proj)
    # the row combine's x = deq(Eq)[id]
    eq, es = qdec["embed"].q, qdec["embed"].scale.reshape(-1)
    r_emb = eq.shape[0] if bits == 8 else -(-V // 2)
    got = torch.tensor([[float(_deq(_qval(eq, bits, r_emb, i, e), es[e]))
                         for e in range(E)] for i in range(V)])
    assert torch.equal(got, embed)
