"""Stacked-LSTM backward recurrence: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/lstm_bptt.py``
(``lstm_bptt_chain``): the decode backward's reverse recurrence over all
layers, with the inter-layer input gradients chained inside each step,
emitting the gate gradients ``d_pre`` for the deferred weight products.

* On CUDA tensors :func:`lstm_bptt_chain` launches the hand-written kernel
  (``csrc/lstm_bptt.cu``, built at first use) or raises.
* On CPU tensors it runs :func:`lstm_bptt_chain_plain`.

``lstm_bptt_chain.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

_count_lock = threading.Lock()


def lstm_bptt_chain_plain(w_hhs, w_ihs_upper, d_hs, gates, cs):
    """Plain PyTorch version → ``d_pre [T, NL, B, 4H]`` float32."""
    T, NL, B, H4 = gates.shape
    H = H4 // 4
    dh = [d_hs.new_zeros(B, H) for _ in range(NL)]
    dc = [d_hs.new_zeros(B, H) for _ in range(NL)]
    d_pre = d_hs.new_empty(T, NL, B, H4)
    for t in range(T - 1, -1, -1):
        d_x_upper = None
        for l in range(NL - 1, -1, -1):
            gi, gf, gg, go = gates[t, l].chunk(4, dim=-1)
            i_g, f_g = torch.sigmoid(gi), torch.sigmoid(gf)
            g_g, o_g = torch.tanh(gg), torch.sigmoid(go)
            dh_in = d_hs[t] if l == NL - 1 else d_x_upper
            dh_l = dh[l] + dh_in
            tc = torch.tanh(cs[t, l])
            do_pre = dh_l * tc * o_g * (1.0 - o_g)
            dc_l = dc[l] + dh_l * o_g * (1.0 - tc * tc)
            cprev = cs[t - 1, l] if t > 0 else torch.zeros_like(dc_l)
            di_pre = dc_l * g_g * i_g * (1.0 - i_g)
            df_pre = dc_l * cprev * f_g * (1.0 - f_g)
            dg_pre = dc_l * i_g * (1.0 - g_g * g_g)
            d = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
            d_pre[t, l] = d
            dh[l] = d @ w_hhs[l].T
            dc[l] = dc_l * f_g
            if l > 0:
                d_x_upper = d @ w_ihs_upper[l - 1].T
    return d_pre


def _check(name, t, shape, device):
    build.check_tensor("lstm_bptt_chain", name, t, shape, device)


def _validate(w_hhs, w_ihs_upper, d_hs, gates, cs):
    if gates.ndim != 4 or gates.shape[3] % 4:
        raise ValueError("lstm_bptt_chain: gates must be [T, NL, B, 4H]")
    T, NL, B, H4 = gates.shape
    H = H4 // 4
    device = d_hs.device
    _check("d_hs", d_hs, (T, B, H), device)
    _check("gates", gates, (T, NL, B, H4), device)
    _check("cs", cs, (T, NL, B, H), device)
    _check("w_hhs", w_hhs, (NL, H, H4), device)
    if NL > 1:
        _check("w_ihs_upper", w_ihs_upper, (NL - 1, H, H4), device)
    return T, NL, B, H


def _library() -> ctypes.CDLL:
    lib = build.load("lstm_bptt")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_lstm_bptt_chain.argtypes = [vp] * 5 + [i] * 4 + [vp] * 5
        lib.gic_lstm_bptt_chain.restype = i
        lib._gic_typed = True
    return lib


def lstm_bptt_chain(w_hhs, w_ihs_upper, d_hs, gates, cs):
    """Whole stacked-LSTM decode backward recurrence.

    Args as the JAX ``lstm_bptt_chain``, float32 and contiguous:
      w_hhs:       [NL, H, 4H] recurrent weights (``w_hh.T`` per layer).
      w_ihs_upper: [NL-1, H, 4H] input weights of layers 1..NL-1
                   (``w_ih.T``); ignored when NL = 1.
      d_hs:        [T, B, H] top-layer hidden cotangents.
      gates:       [T, NL, B, 4H] saved pre-activation gates.
      cs:          [T, NL, B, H] cell states leaving each step.
    Returns ``d_pre [T, NL, B, 4H]`` float32.
    """
    T, NL, B, H = _validate(w_hhs, w_ihs_upper, d_hs, gates, cs)
    device = d_hs.device
    if device.type == "cpu":
        return lstm_bptt_chain_plain(w_hhs, w_ihs_upper, d_hs, gates, cs)
    if device.type != "cuda":
        raise ValueError(f"lstm_bptt_chain: unsupported device {device}")
    lib = _library()
    carries = torch.empty(2, NL, B, H, device=device)
    dx_upper = torch.empty(B, H, device=device)
    d_pre = torch.empty(T, NL, B, 4 * H, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_lstm_bptt_chain(
            w_hhs.data_ptr(), w_ihs_upper.data_ptr() if NL > 1 else None,
            d_hs.data_ptr(), gates.data_ptr(), cs.data_ptr(), T, NL, B, H,
            carries[0].data_ptr(), carries[1].data_ptr(),
            dx_upper.data_ptr(), d_pre.data_ptr(), stream)
    build.raise_on_error(lib, rc, "lstm_bptt_chain")
    with _count_lock:
        lstm_bptt_chain.launches += 1
    return d_pre


lstm_bptt_chain.launches = 0
