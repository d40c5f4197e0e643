"""The kernels of the ``--disc-engine`` routes and the teacher-forced
pass's reverse BPTT against their plain versions on the card: the
per-batch-row conv forward and backward (``csrc/disc_conv_rows.cu``), the
DXS backward (``csrc/disc_conv.cu``) and the single-layer reverse
recurrence (``csrc/lstm_bptt.cu``), at odd sizes (eds = 2, R not a
multiple of 32, B = 1, lv = 1, H not a multiple of the tiles), each
engine's autograd route, and the wrappers' refusals.  Every test skips
without CUDA.  This file imports torch and the port only:

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
    args = _inputs(shape, device)
    before = disc_conv.conv_rows_forward.launches
    pooled, idxs = disc_conv.conv_rows_forward(*args)
    torch.cuda.synchronize()
    assert disc_conv.conv_rows_forward.launches == before + 1
    want, want_idx = disc_conv.conv_relu_maxpool_plain(*args)
    mxu, mxu_idx = disc_conv.conv_bank_forward(*args)
    torch.testing.assert_close(pooled, want, atol=POOL_ATOL, rtol=0)
    torch.testing.assert_close(pooled, mxu, atol=POOL_ATOL, rtol=0)
    for i, iw, im, clear in zip(idxs, want_idx, mxu_idx, _clear(*args)):
        assert int(((i != iw) & clear).sum()) == 0
        assert int(((i != im) & clear).sum()) == 0


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


@pytest.mark.parametrize("shape", SHAPES)
def test_dxs_backward_matches_plain(device, shape):
    emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled = _grads(shape,
                                                                   device)
    dpms, _ = disc_conv._masked(pooled, d_pooled, banks)
    before = disc_conv.conv_bank_dxs.launches
    dxss, dw = disc_conv.conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs,
                                       dpms)
    torch.cuda.synchronize()
    assert disc_conv.conv_bank_dxs.launches == before + 1
    w_dxss, w_dw = disc_conv.conv_dxs_plain(emb_pad, w_all, banks, R, eds,
                                            idxs, dpms)
    for a, b in zip(dxss, w_dxss):
        torch.testing.assert_close(a, b, atol=DX_ATOL, rtol=0)
    assert _dw_rel(dw, w_dw) <= DW_RTOL
    d_emb = disc_conv.overlap_add(dxss, banks, emb_pad.shape, R, eds)
    dx_emb, _ = disc_conv.conv_bank_backward(emb_pad, w_all, banks, R, eds,
                                             idxs, dpms)
    torch.testing.assert_close(d_emb, dx_emb, atol=DX_ATOL, rtol=0)


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
           disc_conv.conv_bank_dxs)
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
