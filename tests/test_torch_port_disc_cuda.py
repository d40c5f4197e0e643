"""The kernels of the ``--disc-engine`` routes and the teacher-forced
pass's reverse BPTT against their plain versions on the card: the
per-batch-row conv forward (the ``mxu`` forward's kernel,
``csrc/disc_conv.cu:gic_conv_fwd``, behind its own counter), the conv
backward of both engines (``csrc/disc_conv.cu:gic_conv_bwd``:
``conv_bank_backward``, ``conv_bank_backward_raw``, ``conv_rows_backward``;
two calls bit-equal, an all-zero gradient, more banks than one launch
takes, rows in windows), the DXS backward (``csrc/disc_conv.cu:
gic_conv_dxs``: ``conv_bank_dxs`` and, from the raw gradient,
``conv_bank_dxs_raw``; the same shapes, items split over launches, two
calls bit-equal, an all-zero gradient) and the single-layer reverse
recurrence
(``csrc/lstm_bptt.cu``), at odd sizes (eds = 2 and 3 with up to 12 taps,
R and B·R not multiples of 32, n not a multiple of 32, B = 1, lv = 1, H
not a multiple of the tiles), each engine's autograd route, and the
wrappers' refusals.  Every test skips without CUDA.  This file imports
torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_disc_cuda.py

Tolerances: pooled within 1e-5 and argmax rows equal wherever the top two
time rows are more than 1e-6 apart; d_emb, DXS and db within 1e-5; dW
within 1e-4 of its largest entry (float32 sums in another order); the
reverse recurrence's d_pre within 1e-4 of its largest entry, dh0 and dc0
within 1e-4.
"""

import numpy as np
import pytest
import torch

from gan_image_captioning_tpu_torch.kernels import disc_conv
from gan_image_captioning_tpu_torch.kernels import lstm_bptt

POOL_ATOL, TIE_GAP, DX_ATOL, DW_RTOL, BPTT_TOL = 1e-5, 1e-6, 1e-5, 1e-4, 1e-4
# (B, L, R, eds, banks ((n, f), ...)); L = f gives lv = 1
SHAPES = [(4, 9, 5, 2, ((8, 3), (6, 4))), (1, 36, 64, 1, ((300, 3),)),
          (3, 5, 37, 1, ((40, 5), (33, 2))), (2, 12, 3, 3, ((65, 4),))]
# the backward's edges besides SHAPES: config3's banks at B = 2 (two
# column tiles), ten banks (two launches of conv_bwd_kernel), and rows
# past one window of the kernel's accumulators, with the taps staged
# (eds 1) and read from w_all (eds 16, 48 taps)
BWD_SHAPES = SHAPES + [
    (2, 36, 64, 1, ((300, 3), (300, 4), (300, 5))),
    (2, 7, 6, 1, tuple((3 + 7 * i, 1 + i % 5) for i in range(10))),
    (3, 130, 13, 1, ((70, 3), (33, 5))),
    (2, 8, 4, 16, ((5, 2), (6, 3)))]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _seeded(shape, seed, device, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32)).to(device)


def _inputs(shape, device):
    b, L, R, eds, banks = shape
    maxf = max(f for _, f in banks)
    emb = _seeded((b, L, R * eds), sum(banks[0]), device)
    convs = [(_seeded((n, 1, f, eds), 10 + f, device, f ** -0.5),
              _seeded((n,), 20 + f, device, 0.1)) for n, f in banks]
    w_all, b_all, banks = disc_conv.fuse_bank_params(convs, eds)
    emb_pad = torch.nn.functional.pad(emb, (0, 0, 0, maxf - 1)).contiguous()
    return emb_pad, w_all.contiguous(), b_all.contiguous(), banks, R, eds


def _clear(emb_pad, w_all, b_all, banks, R, eds):
    """Per bank, where the top two time rows of a live column are more
    than TIE_GAP apart."""
    L = emb_pad.shape[1] - max(f for _, f in banks) + 1
    x, out, off = emb_pad[:, None, :L], [], 0
    for n, f in banks:
        z = torch.relu(torch.nn.functional.conv2d(
            x, w_all[off:off + n, :f * eds].reshape(n, 1, f, eds),
            b_all[off:off + n], stride=(1, eds)))             # [B, n, lv, R]
        if z.shape[2] == 1:
            out.append(torch.ones(z.shape[0], R, n, dtype=torch.bool,
                                  device=z.device))
        else:
            top2 = z.topk(2, dim=2).values
            out.append(((top2[:, :, 0] - top2[:, :, 1]) > TIE_GAP)
                       .transpose(1, 2))
        off += n
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_rows_forward_matches_plain(device, shape):
    emb_pad, w_all, b_all, banks, R, eds = args = _inputs(shape, device)
    before = [disc_conv.conv_rows_forward.launches,
              disc_conv.conv_bank_forward.launches]
    pooled, idxs = disc_conv.conv_rows_forward(*args)
    torch.cuda.synchronize()
    # one count, on the row engine's counter only, and one launch a pass
    assert [disc_conv.conv_rows_forward.launches,
            disc_conv.conv_bank_forward.launches] == [before[0] + 1,
                                                      before[1]]
    L = emb_pad.shape[1] - max(f for _, f in banks) + 1
    assert len(disc_conv.conv_fwd_plan(emb_pad.shape[0] * R, L, eds,
                                       banks)["launches"]) == 1
    want, want_idx = disc_conv.conv_relu_maxpool_plain(*args)
    mxu, mxu_idx = disc_conv.conv_bank_forward(*args)
    torch.testing.assert_close(pooled, want, atol=POOL_ATOL, rtol=0)
    # the mxu forward's kernel: the same bits
    assert torch.equal(pooled, mxu)
    for i, iw, im, clear in zip(idxs, want_idx, mxu_idx, _clear(*args)):
        assert int(((i != iw) & clear).sum()) == 0
        assert torch.equal(i, im)


def _grads(shape, device):
    emb_pad, w_all, b_all, banks, R, eds = args = _inputs(shape, device)
    pooled, idxs = disc_conv.conv_relu_maxpool_plain(*args)
    d_pooled = _seeded(tuple(pooled.shape), 7, device)
    return emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled


def _dw_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES)
def test_rows_backward_matches_plain(device, shape):
    args = _grads(shape, device)
    before = disc_conv.conv_rows_backward.launches
    d_emb, dw, db = disc_conv.conv_rows_backward(*args)
    torch.cuda.synchronize()
    assert disc_conv.conv_rows_backward.launches == before + 1
    w_emb, w_dw, w_db = disc_conv.conv_rows_backward_plain(*args)
    torch.testing.assert_close(d_emb, w_emb, atol=DX_ATOL, rtol=0)
    torch.testing.assert_close(db, w_db, atol=DX_ATOL, rtol=0)
    assert _dw_rel(dw, w_dw) <= DW_RTOL


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bank_backward_matches_plain_and_repeats_bit_for_bit(device, shape):
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(shape,
                                                                   device)
    dpms, w_db = disc_conv._masked(pooled, d_pooled, banks)
    before = disc_conv.conv_bank_backward.launches
    got = disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds, idxs,
                                       dpms)
    raw = disc_conv.conv_bank_backward_raw(emb_pad, w_all, banks, R, eds,
                                           pooled, idxs, d_pooled)
    torch.cuda.synchronize()
    # each call one count: one launch for the banks (two past eight banks)
    # and one reduction, by the plan
    assert disc_conv.conv_bank_backward.launches == before + 2
    L = emb_pad.shape[1] - max(f for _, f in banks) + 1
    plan = disc_conv.conv_bwd_plan(emb_pad.shape[0] * R, L, eds, banks)
    assert plan["kernel_launches"] == 1 + -(-len(banks) // 8)
    w_emb, w_dw = disc_conv.conv_bwd_dx_plain(emb_pad, w_all, banks, R, eds,
                                              idxs, dpms)
    for d_emb, dw in (got, raw[:2]):
        torch.testing.assert_close(d_emb, w_emb, atol=DX_ATOL, rtol=0)
        assert _dw_rel(dw, w_dw) <= DW_RTOL
    torch.testing.assert_close(raw[2], w_db, atol=DX_ATOL, rtol=0)
    # the mask in the launch and outside it: the same sums
    assert _same_bits(got, raw[:2])
    assert _same_bits(got, disc_conv.conv_bank_backward(
        emb_pad, w_all, banks, R, eds, idxs, dpms))
    assert _same_bits(raw, disc_conv.conv_bank_backward_raw(
        emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled))
    # the row engine runs the same kernels, counted on its own wrapper
    before = (disc_conv.conv_bank_backward.launches,
              disc_conv.conv_rows_backward.launches)
    rows = disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds, pooled,
                                        idxs, d_pooled)
    assert _same_bits(rows, raw)
    assert (disc_conv.conv_bank_backward.launches,
            disc_conv.conv_rows_backward.launches) == (before[0],
                                                       before[1] + 1)


@pytest.mark.parametrize("shape", [BWD_SHAPES[0], BWD_SHAPES[-1]])
def test_backward_of_a_zero_gradient_is_zero(device, shape):
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(shape,
                                                                   device)
    dpms = [torch.zeros_like(i, dtype=torch.float32) for i in idxs]
    d_emb, dw = disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds,
                                             idxs, dpms)
    # every entry written, none left from the allocation: all exactly 0
    assert int((d_emb != 0).sum()) == 0 and int((dw != 0).sum()) == 0
    outs = disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds,
                                        -pooled.abs(), idxs, d_pooled)
    assert all(int((o != 0).sum()) == 0 for o in outs)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_dxs_backward_matches_plain(device, shape):
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(shape,
                                                                   device)
    dpms, w_db = disc_conv._masked(pooled, d_pooled, banks)
    raw_args = (emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled)
    before = disc_conv.conv_bank_dxs.launches
    dxss, dw = disc_conv.conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs,
                                       dpms)
    raw = disc_conv.conv_bank_dxs_raw(*raw_args)
    torch.cuda.synchronize()
    # each call one count: its launches and one reduction, by the plan
    assert disc_conv.conv_bank_dxs.launches == before + 2
    w_dxss, w_dw = disc_conv.conv_dxs_plain(emb_pad, w_all, banks, R, eds,
                                            idxs, dpms)
    for a, b in zip(dxss, w_dxss):
        torch.testing.assert_close(a, b, atol=DX_ATOL, rtol=0)
    assert _dw_rel(dw, w_dw) <= DW_RTOL
    # from the raw gradient: the mask in the launch gives the same sums,
    # and db as _masked sums it
    assert _same_bits(dxss, raw[0]) and torch.equal(dw, raw[1])
    torch.testing.assert_close(raw[2], w_db, atol=DX_ATOL, rtol=0)
    again = disc_conv.conv_bank_dxs_raw(*raw_args)
    assert _same_bits(raw[0], again[0]) and _same_bits(raw[1:], again[1:])
    d_emb = disc_conv.overlap_add(dxss, banks, emb_pad.shape, R, eds)
    dx_emb, _ = disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds,
                                             idxs, dpms)
    torch.testing.assert_close(d_emb, dx_emb, atol=DX_ATOL, rtol=0)


def test_dxs_backward_of_a_zero_gradient_is_zero(device):
    # every entry of DXS, dW and db written, none left from the allocation
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(
        BWD_SHAPES[-1], device)
    dxss, dw, db = disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds,
                                               -pooled.abs(), idxs, d_pooled)
    assert all(int((o != 0).sum()) == 0 for o in (*dxss, dw, db))


@pytest.mark.parametrize("engine", ["pallas", "hybrid", "mxu", "mxu_dxs"])
def test_engine_routes_match_the_plain_route(device, engine):
    emb_pad, w_all, b_all, banks, R, eds = _inputs(SHAPES[0], device)
    g = _seeded((emb_pad.shape[0], R, w_all.shape[0]), 8, device)

    def run(eng, ctx):
        leaves = [t.clone().requires_grad_(True)
                  for t in (emb_pad, w_all, b_all)]
        with ctx:
            out = disc_conv.conv_relu_maxpool(*leaves, banks, R, eds, eng)
        return out, torch.autograd.grad(out, leaves, g)

    with disc_conv.argmax_record() as rows:
        out, grads = run(engine, torch.enable_grad())
    ref, ref_grads = run("plain", disc_conv.argmax_replay(rows))
    torch.testing.assert_close(out, ref, atol=POOL_ATOL, rtol=0)
    for a, b in zip(grads, ref_grads):
        assert _dw_rel(a, b) <= DW_RTOL


def test_conv_wrappers_refuse_malformed_calls(device):
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(SHAPES[0],
                                                                   device)
    b_all = torch.zeros(w_all.shape[0], device=device)
    dpms, _ = disc_conv._masked(pooled, d_pooled, banks)
    fns = (disc_conv.conv_rows_forward, disc_conv.conv_rows_backward,
           disc_conv.conv_bank_dxs, disc_conv.conv_bank_backward)
    before = [f.launches for f in fns]
    with pytest.raises(TypeError):
        disc_conv.conv_rows_forward(emb_pad.double(), w_all, b_all, banks, R,
                                    eds)
    with pytest.raises(ValueError):
        disc_conv.conv_rows_forward(emb_pad.cpu(), w_all, b_all, banks, R,
                                    eds)
    with pytest.raises(ValueError):
        disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds,
                                     pooled, idxs,
                                     d_pooled.transpose(0, 1).contiguous()
                                     .transpose(0, 1))
    with pytest.raises(TypeError):
        disc_conv.conv_rows_backward(emb_pad, w_all, banks, R, eds, pooled,
                                     [i.long() for i in idxs], d_pooled)
    with pytest.raises(ValueError):
        disc_conv.conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs,
                                [d[:, :2] for d in dpms])
    with pytest.raises(ValueError):
        disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds,
                                    pooled.cpu(), idxs, d_pooled)
    with pytest.raises(TypeError):
        disc_conv.conv_bank_dxs_raw(emb_pad, w_all, banks, R, eds, pooled,
                                    idxs, d_pooled.double())
    with pytest.raises(TypeError):
        disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds, idxs,
                                     [d.double() for d in dpms])
    with pytest.raises(ValueError):
        disc_conv.conv_bank_backward_raw(emb_pad, w_all, banks, R, eds,
                                         pooled, idxs, d_pooled[:, :2])
    with pytest.raises(ValueError):
        disc_conv.conv_bank_backward_raw(emb_pad, w_all, banks, R, eds,
                                         pooled.cpu(), idxs, d_pooled)
    # 2000 time rows leave the kernel no shared memory for one row of
    # accumulators: the C side refuses the call
    long = _grads((1, 2000, 1, 1, ((4, 3),)), device)
    with pytest.raises(RuntimeError):
        disc_conv.conv_rows_backward(*long)
    # nor one tap's accumulators of the DXS backward: its plan refuses it
    with pytest.raises(ValueError):
        disc_conv.conv_bank_dxs_raw(*long)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("T,B,H", [(1, 3, 20), (7, 5, 16), (36, 64, 512)])
def test_reverse_bptt_matches_plain(device, T, B, H):
    w_hh = _seeded((H, 4 * H), 1, device, H ** -0.5)
    d_hs = _seeded((T, B, H), 2, device)
    gates = _seeded((T, B, 4 * H), 3, device)
    cs = _seeded((T, B, H), 4, device)
    c_prev = torch.cat([_seeded((1, B, H), 5, device), cs[:-1]])
    before = lstm_bptt.lstm_bptt_reverse.launches
    got = lstm_bptt.lstm_bptt_reverse(w_hh, d_hs, gates, c_prev, cs)
    torch.cuda.synchronize()
    assert lstm_bptt.lstm_bptt_reverse.launches == before + 1
    want = lstm_bptt.lstm_bptt_reverse_plain(w_hh, d_hs, gates, c_prev, cs)
    assert _dw_rel(got[0], want[0]) <= BPTT_TOL
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=BPTT_TOL, rtol=BPTT_TOL)


def test_reverse_bptt_refuses_malformed_calls(device):
    T, B, H = 4, 3, 8
    args = [_seeded(s, i, device) for i, s in enumerate(
        [(H, 4 * H), (T, B, H), (T, B, 4 * H), (T, B, H), (T, B, H)])]
    before = lstm_bptt.lstm_bptt_reverse.launches
    with pytest.raises(ValueError):
        lstm_bptt.lstm_bptt_reverse(args[0][:, :H], *args[1:])
    with pytest.raises(TypeError):
        lstm_bptt.lstm_bptt_reverse(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        lstm_bptt.lstm_bptt_reverse(*args[:3], args[3].cpu(), args[4])
    with pytest.raises(ValueError):
        lstm_bptt.lstm_bptt_reverse(args[0], args[1].transpose(0, 1),
                                    *args[2:])
    assert lstm_bptt.lstm_bptt_reverse.launches == before
