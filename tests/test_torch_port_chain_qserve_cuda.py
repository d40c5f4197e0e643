"""The persistent BPTT chain and the persistent quantized serve decode
(one cooperative launch per call each) on the card, at the edges of their
launch plans.  Every test skips without CUDA.  This file imports torch and
the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_chain_qserve_cuda.py

The chain against ``lstm_bptt_chain_plain`` at NL 1, 2 and 3, H 512
(resident weight rows up to NL = 2), 1024 (streamed) and 2048 (16 units a
block, in passes), B 1, 8, 64 and 600-1024 (in batch chunks), T 1 and
36, and ragged widths: d_pre within 1e-4 of its largest entry
(the kernel splits K, so sums are taken in another order).  The quantized
decode, int8 and packed int4, against the dense persistent kernel on
``dequantized_decoder``'s weights: ids and logprobs equal, bit for bit,
full T and each of the chained carried chunks (which together equal
the full decode: ids equal, logprobs within 1e-6), at an odd vocabulary
(the packed embedding's pad row, the projection's unaligned byte path),
at config3 widths (the cp.async byte ring) and at H = 1024 (the gate
rows dequantized into the K-tile stage each step).
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import build
from gan_image_captioning_tpu_torch.kernels import decode_sample as ds
from gan_image_captioning_tpu_torch.kernels import lstm_bptt
from gan_image_captioning_tpu_torch.ops.quantize import (
    QTensor, quantize, quantize_packed_int4)

CHAIN_RTOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(rng, device, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(device)


def _chain_inputs(T, NL, B, H, device, seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    return (_t(rng, device, NL, H, 4 * H, scale=k),
            _t(rng, device, max(NL - 1, 1), H, 4 * H, scale=k),
            _t(rng, device, T, B, H), _t(rng, device, T, NL, B, 4 * H),
            _t(rng, device, T, NL, B, H, scale=0.5))


# (NL, H, B, T): the resident branch (H = 512, NL <= 2), the streamed one
# (NL = 3, or H = 1024: 8 units a block, the two products of a layer in
# separate passes; H = 2048: 16 units, two passes a product), one row, a
# partial warp of rows (B = 33), T = 1; the batch in chunks whose carries
# fit in shared memory (B = 1024 beside resident rows, B = 600 beside
# streamed ones)
CHAIN_SHAPES = [(1, 512, 1, 1), (2, 512, 64, 36), (2, 512, 8, 36),
                (2, 512, 1, 36), (3, 512, 64, 36), (3, 512, 8, 1),
                (1, 1024, 64, 36), (2, 1024, 8, 36), (2, 1024, 64, 1),
                (3, 1024, 1, 36), (2, 40, 33, 5), (3, 130, 65, 3),
                (2, 512, 1024, 36), (3, 1024, 600, 3), (2, 2048, 8, 36),
                (1, 2048, 64, 5)]


@pytest.mark.parametrize("NL,H,B,T", CHAIN_SHAPES)
def test_chain_matches_plain(device, NL, H, B, T):
    args = _chain_inputs(T, NL, B, H, device, seed=NL * 100 + B + T)
    plan = lstm_bptt.chain_plan(B, H, NL, *build.device_limits(
        lstm_bptt._library(), device))
    assert plan["resident"] == (H < 512 or (H == 512 and NL < 3))
    assert (plan["batch_chunk"] < B) == (B >= 600)
    branch = "resident" if plan["resident"] else "streamed"
    before = (lstm_bptt.lstm_bptt_chain.launches,
              lstm_bptt.lstm_bptt_chain.branches[branch])
    got = lstm_bptt.lstm_bptt_chain(*args)
    assert (lstm_bptt.lstm_bptt_chain.launches,
            lstm_bptt.lstm_bptt_chain.branches[branch]) == (
        before[0] + 1, before[1] + 1)
    assert lstm_bptt.lstm_bptt_chain.last_plan == plan
    want = lstm_bptt.lstm_bptt_chain_plain(*args)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= CHAIN_RTOL * scale, (err, scale)


def test_chain_plan_that_cannot_be_co_resident_raises(device):
    n_sm, smem = build.device_limits(lstm_bptt._library(), device)
    with pytest.raises(ValueError, match="co-resident"):
        lstm_bptt.chain_plan(64, 512, 2, n_sm, smem, blocks=n_sm + 1)


def _qdec(E, H, V, nl, bits, device, seed=0):
    """A quantized decoder in ops/quantize.py's layout, from a seed."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def on(qt):
        return QTensor(qt.q.to(device), qt.scale.to(device))

    k = 1.0 / np.sqrt(H)
    if bits == 8:
        qfn = qemb = lambda w: quantize(w, bits=8)  # noqa: E731
    else:
        qfn = quantize_packed_int4

        def qemb(w):
            return quantize_packed_int4(w, pad_odd=True)
    return {"embed": on(qemb(t(V, E))),
            "lstm_q": [{"w": on(qfn(t((E if l == 0 else H) + H, 4 * H,
                                      scale=k))),
                        "b": t(4 * H, scale=k).to(device)}
                       for l in range(nl)],
            "linear": {"w": on(qfn(t(H, V, scale=4 * k))),
                       "b": t(V, scale=0.1).to(device)}}


# (B, V, E, H, nl, T, K): an odd vocabulary (V % 16 != 0: the byte path
# without cp.async; int4: the embedding's pad row), E and H not multiples
# of 4, config3 widths at B = 1, 8 and 64, and H = 1024 (streamed)
Q_SHAPES = [(3, 131, 46, 42, 2, 9, 4), (1, 11008, 512, 512, 2, 36, 8),
            (8, 11008, 512, 512, 2, 36, 8), (64, 11008, 512, 512, 2, 36, 8),
            (5, 301, 64, 1024, 2, 5, 2), (33, 257, 32, 36, 3, 7, 3)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", Q_SHAPES)
def test_quantized_equals_dense_on_dequantized(device, shape, bits):
    B, V, E, H, nl, T, K = shape
    qdec = _qdec(E, H, V, nl, bits, device, seed=B + V + bits)
    dense = ds.dequantized_decoder(qdec, bits)
    feats = _t(np.random.default_rng(B), device, B, E)
    plan = ds.persistent_plan(B, E, H, V, nl, *build.device_limits(
        ds._library(), device), quantized=True)
    assert plan["resident"] == (H != 1024)
    before = ds.decode_sample_q_serve.launches
    ids, lps = ds.decode_sample_q_serve(feats, qdec, T, bits=bits)
    assert ds.decode_sample_q_serve.launches == before + 1
    assert ds.last_plan == plan
    ids_d, lps_d = ds.decode_sample(feats, *dense, T, mode="serve")
    torch.cuda.synchronize()
    assert torch.equal(ids, ids_d)
    assert torch.equal(lps, lps_d)
    # chained carried chunks: equal to the full decode and to the dense
    # kernel's chunks
    h = torch.zeros(nl, B, H, device=device)
    c, x, t, parts = h.clone(), feats, 0, []
    hd, cd, xd = h.clone(), h.clone(), feats
    while t < T:
        k = min(K, T - t)
        i, lp, (h, c, x) = ds.decode_sample_q_serve(x, qdec, k, (h, c, x),
                                                    bits=bits)
        i_d, lp_d, (hd, cd, xd) = ds.decode_sample(
            xd, *dense, k, mode="serve", init_state=(hd, cd, xd))
        torch.cuda.synchronize()
        assert torch.equal(i, i_d) and torch.equal(lp, lp_d)
        for a, b in ((h, hd), (c, cd), (x, xd)):
            assert torch.equal(a, b)
        parts.append((i, lp))
        t += k
    # the same operations as one full decode (the dense kernel's own
    # chained-chunk rule: ids equal, logprobs within 1e-6)
    assert torch.equal(torch.cat([p[0] for p in parts], 1), ids)
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 1), lps,
                               atol=1e-6, rtol=0)
    assert torch.equal(x, dense[3][ids[:, -1].long()])
