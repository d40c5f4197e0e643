"""Blocked (flash) self-attention: the CUDA kernels and the plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/flash_attention.py``
(``flash_attention``): softmax(QKᵀ/√D)V over ``[B, T, H, D]`` tensors with
one of the three masks the transformer family builds — full or causal, each
with or without per-sequence key lengths — and its gradient, without a
``[B, H, T, T]`` score tensor in device memory in either direction.

* On CUDA tensors :func:`flash_attention` is a ``torch.autograd.Function``
  whose forward launches the forward kernel (``csrc/flash_attention.cu``,
  built at first use; it also writes the logsumexp ``lse [B, T, H]``) and
  whose backward launches the dQ and the dK/dV kernels.  The forward is
  one launch of one of two kernels, which the C side picks from the shape
  alone: the fused one, whole heads of q, k and v in shared memory
  (T ≤ 64 and D ≤ 32: every call the system makes), or the tiled one;
  ``flash_fwd.last_kernel`` says which it launched.  ``delta = Σ dO∘O`` is one PyTorch reduction, as the JAX package leaves
  it to XLA.  A shape the kernels do not take (:func:`supported`), or a
  q, k or v that is not 16-byte aligned (a view at an odd offset; PyTorch
  allocates on 256 bytes), raises.
* On CPU tensors it runs :func:`attention_plain`, the dense version that
  mirrors the JAX package's ``attention_reference`` (mask fill
  ``finfo.min``), with PyTorch's autograd.

``flash_fwd.launches``, ``flash_dq.launches`` and ``flash_dkv.launches``
count the kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

_count_lock = threading.Lock()


def supported(t: int, d: int) -> bool:
    """Shape eligibility (the JAX package's predicate): a head dim that is
    a multiple of 8 up to 256; any T."""
    return t >= 1 and d % 8 == 0 and d <= 256


def attention_plain(q, k, v, causal: bool, lengths=None):
    """Dense attention over ``[B, T, H, D]`` (``attention_reference``):
    masked scores filled with the dtype's most negative value."""
    b, t, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones((1, 1, t, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & torch.tril(mask)
    if lengths is not None:
        key_ok = (torch.arange(t, device=q.device)[None, :]
                  < lengths.to(q.device)[:, None])
        mask = mask & key_ok[:, None, None, :]
    s = torch.where(mask, s, torch.finfo(s.dtype).min)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_gic_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gic_flash_fwd.argtypes = [vp] * 6 + [i] * 5 + [
            f, vp, ctypes.POINTER(i)]
        lib.gic_flash_dq.argtypes = [vp] * 8 + [i] * 5 + [f, vp]
        lib.gic_flash_dkv.argtypes = [vp] * 9 + [i] * 5 + [f, vp]
        for fn in (lib.gic_flash_fwd, lib.gic_flash_dq, lib.gic_flash_dkv):
            fn.restype = i
        lib._gic_typed = True
    return lib


def _count(fn):
    with _count_lock:
        fn.launches += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, shape, device, dtype=None):
    build.check_tensor("flash_attention", name, t, shape, device, dtype)


def _validate(q, k, v, lengths):
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be [B, T, H, D], got "
                         f"{tuple(q.shape)}")
    b, t, h, d = q.shape
    if not supported(t, d):
        raise ValueError(f"flash_attention: unsupported shape T={t} D={d}")
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention: the kernels take CUDA tensors, "
                         f"got {device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (b, t, h, d), device)
        # the fused forward stages rows by 16-byte copies
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    if lengths is not None:
        _check("lengths", lengths, (b,), device, torch.int32)
    return b, t, h, d


def flash_fwd(q, k, v, causal: bool, lengths=None):
    """The forward kernel → ``(out [B, T, H, D], lse [B, T, H])``.
    ``flash_fwd.last_kernel`` names the kernel the C side launched:
    ``"fused"`` or ``"tiled"``."""
    b, t, h, d = _validate(q, k, v, lengths)
    device = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=device)
    lib = _library()
    fused = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gic_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               _ptr(lengths), out.data_ptr(), lse.data_ptr(),
                               b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                               _stream(device), ctypes.byref(fused))
    build.raise_on_error(lib, rc, "flash_attention forward")
    flash_fwd.last_kernel = "fused" if fused.value else "tiled"
    _count(flash_fwd)
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, causal: bool, lengths=None):
    """The dQ kernel → ``dq [B, T, H, D]``."""
    b, t, h, d = _validate(q, k, v, lengths)
    device = q.device
    _check("dout", dout, (b, t, h, d), device)
    _check("lse", lse, (b, t, h), device)
    _check("delta", delta, (b, t, h), device)
    dq = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), _ptr(lengths), dq.data_ptr(),
                              b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                              _stream(device))
    build.raise_on_error(lib, rc, "flash_attention dQ")
    _count(flash_dq)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool, lengths=None):
    """The dK/dV kernel → ``(dk, dv)``, each ``[B, T, H, D]``."""
    b, t, h, d = _validate(q, k, v, lengths)
    device = q.device
    _check("dout", dout, (b, t, h, d), device)
    _check("lse", lse, (b, t, h), device)
    _check("delta", delta, (b, t, h), device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), _ptr(lengths),
                               dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                               int(causal), 1.0 / math.sqrt(d),
                               _stream(device))
    build.raise_on_error(lib, rc, "flash_attention dK/dV")
    _count(flash_dkv)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = delta (one reduction) + dQ + dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        out, lse = flash_fwd(q, k, v, causal, lengths)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        g = g.contiguous()
        delta = (g * out).sum(dim=-1)                   # [B, T, H]
        dq = flash_dq(q, k, v, g, lse, delta, ctx.causal, lengths)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal, lengths)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool, lengths=None):
    """Self-attention over ``[B, T, H, D]`` (bqhd) tensors.

    ``causal``: lower-triangular mask, else full.  ``lengths``: optional
    ``[B]`` — per sequence the number of valid key positions (keys at index
    ≥ ``lengths[b]`` are masked for every query row); None = all T valid.
    Differentiable in q, k and v.  CUDA tensors go through the kernels (or
    raise), CPU tensors through :func:`attention_plain`."""
    b, t, h, d = q.shape
    if not supported(t, d):
        raise ValueError(f"flash_attention: unsupported shape T={t} D={d}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    lens = None
    if lengths is not None:
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), lens, bool(causal))


flash_fwd.launches = 0
flash_fwd.last_kernel = None
flash_dq.launches = 0
flash_dkv.launches = 0
