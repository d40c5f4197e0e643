"""Greedy serve-mode LSTM decode: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/decode_sample.py``
(``decode_sample`` modes ``serve`` and ``greedy``).  One call runs the
whole T-step decode: stacked LSTM gates, vocabulary projection, per-token
greedy log-probability, first-index argmax and embedding feedback.

* On CUDA tensors :func:`decode_sample` launches the hand-written kernel
  (``csrc/decode_serve.cu``, built at first use) or raises.
* On CPU tensors it runs :func:`decode_sample_plain`, the same arithmetic
  as a Python loop of PyTorch operations.  Nothing falls back from one to
  the other.

``decode_sample.launches`` counts the kernel launches (one per call that
reached the card).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence

import torch

from gan_image_captioning_tpu_torch.kernels import build

_PORTED_MODES = ("serve", "greedy")
_count_lock = threading.Lock()


def decode_sample_plain(features, lstm_layers: Sequence[dict], w_proj, b_proj,
                        embed, seq_len: int):
    """Plain PyTorch version → ``(ids [B, T] int32, lps [B, T] f32)``."""
    B = features.shape[0]
    H = lstm_layers[0]["w_hh"].shape[1]
    h = [features.new_zeros(B, H) for _ in lstm_layers]
    c = [features.new_zeros(B, H) for _ in lstm_layers]
    x = features
    ids, lps = [], []
    with torch.no_grad():
        for _ in range(seq_len):
            inp = x
            for l, p in enumerate(lstm_layers):
                gates = (inp @ p["w_ih"].T + h[l] @ p["w_hh"].T
                         + (p["b_ih"] + p["b_hh"]))
                gi, gf, gg, go = gates.chunk(4, dim=-1)
                c[l] = torch.sigmoid(gf) * c[l] + torch.sigmoid(gi) * torch.tanh(gg)
                h[l] = torch.sigmoid(go) * torch.tanh(c[l])
                inp = h[l]
            logits = inp @ w_proj.T + b_proj
            m = logits.max(dim=-1, keepdim=True).values
            lps.append(-torch.log(torch.exp(logits - m).sum(dim=-1)))
            ids_t = torch.argmax(logits, dim=-1)      # first index on ties
            ids.append(ids_t)
            x = embed[ids_t]
    return (torch.stack(ids, dim=1).to(torch.int32),
            torch.stack(lps, dim=1))


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"decode_sample: {name} is on {t.device}, "
                         f"features on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"decode_sample: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_sample: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_sample: {name} must be contiguous")


def _validate(features, lstm_layers, w_proj, b_proj, embed, seq_len):
    if features.ndim != 2 or not lstm_layers:
        raise ValueError("decode_sample: features must be [B, E] and "
                         "lstm_layers non-empty")
    B, E = features.shape
    V = embed.shape[0]
    H = lstm_layers[0]["w_hh"].shape[1]
    device = features.device
    if B < 1 or seq_len < 1:
        raise ValueError(f"decode_sample: batch {B} and seq_len {seq_len} "
                         "must be positive")
    _check("features", features, (B, E), device)
    _check("embed", embed, (V, E), device)
    _check("w_proj", w_proj, (V, H), device)
    _check("b_proj", b_proj, (V,), device)
    for l, p in enumerate(lstm_layers):
        in_dim = E if l == 0 else H
        _check(f"layer {l} w_ih", p["w_ih"], (4 * H, in_dim), device)
        _check(f"layer {l} w_hh", p["w_hh"], (4 * H, H), device)
        _check(f"layer {l} b_ih", p["b_ih"], (4 * H,), device)
        _check(f"layer {l} b_hh", p["b_hh"], (4 * H,), device)
    return B, E, H, V


def _library() -> ctypes.CDLL:
    lib = build.load("decode_serve")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_proj_tile.argtypes = []
        lib.gic_proj_tile.restype = i
        lib.gic_error_string.argtypes = [i]
        lib.gic_error_string.restype = ctypes.c_char_p
        lib.gic_decode_serve.argtypes = (
            [vp] * 4 + [ctypes.POINTER(vp)] + [i] * 6 + [vp] * 9)
        lib.gic_decode_serve.restype = i
        lib._gic_typed = True
    return lib


def _launch(features, lstm_layers, w_proj, b_proj, embed, seq_len):
    """The CUDA kernel: validates, allocates outputs and scratch with
    ``torch.empty`` and runs the decode on the current stream."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len)
    device = features.device
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    # b_ih + b_hh once per call, as the TPU kernel's wrapper does
    biases: List[torch.Tensor] = [(p["b_ih"] + p["b_hh"]).contiguous()
                                  for p in lstm_layers]
    ptrs = []
    for p, bias in zip(lstm_layers, biases):
        ptrs += [p["w_ih"].data_ptr(), p["w_hh"].data_ptr(), bias.data_ptr()]
    layer_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    x, h, c = empty(B, E), empty(2, nl, B, H), empty(nl, B, H)
    pmax, psum = empty(B, ntile), empty(B, ntile)
    pidx = empty(B, ntile, dtype=torch.int32)
    ids, lps = empty(B, seq_len, dtype=torch.int32), empty(B, seq_len)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_serve(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            x.data_ptr(), h.data_ptr(), c.data_ptr(), pmax.data_ptr(),
            pidx.data_ptr(), psum.data_ptr(), ids.data_ptr(), lps.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"decode_serve kernel failed: CUDA error {rc} "
                           f"({lib.gic_error_string(rc).decode()})")
    with _count_lock:
        decode_sample.launches += 1
    return ids, lps


def decode_sample(features, lstm_layers: Sequence[dict], w_proj, b_proj,
                  embed, seq_len: int, mode: str = "greedy",
                  init_state=None):
    """Run the full T-step greedy decode.

    Args mirror the JAX ``decode_sample``: ``features [B, E]`` (the t=0
    input), per-layer ``{w_ih [4H, In], w_hh [4H, H], b_ih, b_hh}``,
    ``w_proj [V, H]``, ``b_proj [V]``, ``embed [V, E]``, all float32.
    Returns ``ids [B, T]`` (``greedy``) or ``(ids [B, T] int32,
    lps [B, T] f32)`` (``serve``).
    """
    if mode not in _PORTED_MODES:
        raise NotImplementedError(f"decode_sample mode {mode!r} is not "
                                  "ported yet")
    if init_state is not None:
        raise NotImplementedError("decode_sample with init_state (the "
                                  "carried-state variant) is not ported yet")
    if features.device.type == "cuda":
        ids, lps = _launch(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len)
    elif features.device.type == "cpu":
        _validate(features, lstm_layers, w_proj, b_proj, embed, seq_len)
        ids, lps = decode_sample_plain(features, lstm_layers, w_proj, b_proj,
                                       embed, seq_len)
    else:
        raise ValueError(f"decode_sample: unsupported device "
                         f"{features.device}")
    return ids if mode == "greedy" else (ids, lps)


decode_sample.launches = 0
