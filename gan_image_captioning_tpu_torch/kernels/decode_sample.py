"""Stacked-LSTM free-running decode: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/decode_sample.py``
(``decode_sample`` modes ``serve``, ``greedy`` and ``sample_resid``).  One
call runs the whole T-step decode: stacked LSTM gates, vocabulary
projection, first-index argmax and embedding feedback, with the per-token
greedy log-probability (``serve``) or with Gumbel noise, the soft sample
``softmax(temp * (logits + g))`` and the BPTT residuals (``sample_resid``).

* On CUDA tensors :func:`decode_sample` launches the hand-written kernel
  (``csrc/decode_serve.cu``, built at first use) or raises.
* On CPU tensors it runs :func:`decode_sample_plain` /
  :func:`decode_sample_resid_plain`, the same arithmetic as a Python loop
  of PyTorch operations.  Nothing falls back from one to the other.

``decode_sample.launches`` counts the serve/greedy kernel launches and
``decode_sample_resid.launches`` the sample-mode ones (one per call that
reached the card).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from gan_image_captioning_tpu_torch.kernels import build
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise

_PORTED_MODES = ("serve", "greedy", "sample_resid")
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


def seeded_uniforms(seed: int, shape, device):
    """U[0, 1) float32 uniforms from a ``torch.Generator`` on ``device``
    seeded with ``seed``: the plain versions' stand-in for the kernel's
    Philox draw (another stream, the same distribution)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def decode_sample_resid_plain(features, lstm_layers: Sequence[dict], w_proj,
                              b_proj, embed, seq_len: int, uniforms,
                              temperature: float):
    """Plain PyTorch version of mode ``sample_resid`` with the uniforms
    ``[T, B, V]`` given → ``(ids [B, T] int32, soft [T, B, V],
    hs [T, NL, B, H], cs [T, NL, B, H], gates [T, NL, B, 4H])``."""
    B = features.shape[0]
    H = lstm_layers[0]["w_hh"].shape[1]
    h = [features.new_zeros(B, H) for _ in lstm_layers]
    c = [features.new_zeros(B, H) for _ in lstm_layers]
    x = features
    ids, soft, hs, cs, gates_all = [], [], [], [], []
    with torch.no_grad():
        for t in range(seq_len):
            inp = x
            step_gates = []
            for l, p in enumerate(lstm_layers):
                gates = (inp @ p["w_ih"].T + h[l] @ p["w_hh"].T
                         + (p["b_ih"] + p["b_hh"]))
                gi, gf, gg, go = gates.chunk(4, dim=-1)
                c[l] = torch.sigmoid(gf) * c[l] + torch.sigmoid(gi) * torch.tanh(gg)
                h[l] = torch.sigmoid(go) * torch.tanh(c[l])
                inp = h[l]
                step_gates.append(gates)
            scores = (inp @ w_proj.T + b_proj
                      + gumbel_noise(uniforms[t].shape, u=uniforms[t]))
            ids_t = torch.argmax(scores, dim=-1)      # first index on ties
            ids.append(ids_t)
            soft.append(torch.softmax(scores * temperature, dim=-1))
            hs.append(torch.stack(h))
            cs.append(torch.stack(c))
            gates_all.append(torch.stack(step_gates))
            x = embed[ids_t]
    return (torch.stack(ids, dim=1).to(torch.int32), torch.stack(soft),
            torch.stack(hs), torch.stack(cs), torch.stack(gates_all))


def _check(name, t, shape, device):
    build.check_tensor("decode_sample", name, t, shape, device)


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
        lib.gic_decode_serve.argtypes = (
            [vp] * 4 + [ctypes.POINTER(vp)] + [i] * 6 + [vp] * 9)
        lib.gic_decode_serve.restype = i
        lib.gic_decode_sample_resid.argtypes = (
            [vp] * 4 + [ctypes.POINTER(vp)] + [i] * 6
            + [ctypes.c_float, ctypes.c_uint64] + [vp] * 15)
        lib.gic_decode_sample_resid.restype = i
        lib._gic_typed = True
    return lib


def _layer_pointers(lstm_layers):
    """``b_ih + b_hh`` once per call (as the TPU kernel's wrapper does) and
    the ``(w_ih, w_hh, bias)`` pointer array; the bias tensors are returned
    so they outlive the launch."""
    biases = [(p["b_ih"] + p["b_hh"]).contiguous() for p in lstm_layers]
    ptrs = []
    for p, bias in zip(lstm_layers, biases):
        ptrs += [p["w_ih"].data_ptr(), p["w_hh"].data_ptr(), bias.data_ptr()]
    return biases, (ctypes.c_void_p * len(ptrs))(*ptrs)


def _empty_on(device):
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    return empty


def _launch(features, lstm_layers, w_proj, b_proj, embed, seq_len):
    """The serve-mode CUDA kernel: validates, allocates outputs and scratch
    with ``torch.empty`` and runs the decode on the current stream."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len)
    device = features.device
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    biases, layer_ptrs = _layer_pointers(lstm_layers)
    empty = _empty_on(device)
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
    build.raise_on_error(lib, rc, "decode_serve")
    with _count_lock:
        decode_sample.launches += 1
    return ids, lps


def decode_sample_resid(features, lstm_layers: Sequence[dict], w_proj,
                        b_proj, embed, seq_len: int, seed: int = 0,
                        temperature: float = 1.0, uniforms=None,
                        uniforms_out=None):
    """Mode ``sample_resid`` → ``(ids [B, T] int32, soft [T, B, V],
    hs [T, NL, B, H], cs [T, NL, B, H], gates [T, NL, B, 4H])``.

    The Gumbel uniforms are ``uniforms [T, B, V]`` when given; otherwise
    the kernel draws them with Philox keyed by ``seed`` (on the CPU:
    ``torch.rand`` from a generator seeded with ``seed``).  A float32
    ``uniforms_out [T, B, V]`` receives the uniforms used."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len)
    device = features.device
    for name, u in (("uniforms", uniforms), ("uniforms_out", uniforms_out)):
        if u is not None:
            _check(name, u, (seq_len, B, V), device)
    if device.type == "cpu":
        if uniforms is None:
            uniforms = seeded_uniforms(seed, (seq_len, B, V), device)
        if uniforms_out is not None:
            uniforms_out.copy_(uniforms)
        return decode_sample_resid_plain(features, lstm_layers, w_proj,
                                         b_proj, embed, seq_len, uniforms,
                                         float(temperature))
    if device.type != "cuda":
        raise ValueError(f"decode_sample: unsupported device {device}")
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    biases, layer_ptrs = _layer_pointers(lstm_layers)
    empty = _empty_on(device)
    x, h, c = empty(B, E), empty(2, nl, B, H), empty(nl, B, H)
    psmax, pzmax, pzsum = (empty(B, ntile), empty(B, ntile),
                           empty(B, ntile))
    psidx = empty(B, ntile, dtype=torch.int32)
    ids = empty(B, seq_len, dtype=torch.int32)
    soft = empty(seq_len, B, V)
    hs, cs = empty(seq_len, nl, B, H), empty(seq_len, nl, B, H)
    gates = empty(seq_len, nl, B, 4 * H)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_sample_resid(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            float(temperature), int(seed) & (2 ** 64 - 1), ptr(uniforms),
            ptr(uniforms_out), x.data_ptr(), h.data_ptr(), c.data_ptr(),
            psmax.data_ptr(), psidx.data_ptr(), pzmax.data_ptr(),
            pzsum.data_ptr(), ids.data_ptr(), soft.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), gates.data_ptr(), stream)
    build.raise_on_error(lib, rc, "decode_sample_resid")
    with _count_lock:
        decode_sample_resid.launches += 1
    return ids, soft, hs, cs, gates


def decode_sample(features, lstm_layers: Sequence[dict], w_proj, b_proj,
                  embed, seq_len: int, mode: str = "greedy",
                  init_state=None, seed: int = 0, temperature: float = 1.0,
                  uniforms=None):
    """Run the full T-step decode.

    Args mirror the JAX ``decode_sample``: ``features [B, E]`` (the t=0
    input), per-layer ``{w_ih [4H, In], w_hh [4H, H], b_ih, b_hh}``,
    ``w_proj [V, H]``, ``b_proj [V]``, ``embed [V, E]``, all float32;
    ``seed``, ``temperature`` and ``uniforms`` are read by
    ``sample_resid`` only (see :func:`decode_sample_resid`).
    Returns ``ids [B, T]`` (``greedy``), ``(ids [B, T] int32,
    lps [B, T] f32)`` (``serve``) or ``(ids, soft, hs, cs, gates)``
    (``sample_resid``).
    """
    if mode not in _PORTED_MODES:
        raise NotImplementedError(f"decode_sample mode {mode!r} is not "
                                  "ported yet")
    if init_state is not None:
        raise NotImplementedError("decode_sample with init_state (the "
                                  "carried-state variant) is not ported yet")
    if mode == "sample_resid":
        return decode_sample_resid(features, lstm_layers, w_proj, b_proj,
                                   embed, seq_len, seed, temperature,
                                   uniforms)
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
decode_sample_resid.launches = 0
