"""Blocked (flash) self-attention: the CUDA kernels and the plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/flash_attention.py``
(``flash_attention``): softmax(QKᵀ/√D)V over ``[B, T, H, D]`` tensors with
one of the three masks the transformer family builds — full or causal, each
with or without per-sequence key lengths — and its gradient, without a
``[B, H, T, T]`` score tensor in device memory in either direction.

* On CUDA tensors :func:`flash_attention` is a ``torch.autograd.Function``
  whose forward launches the forward kernel (``csrc/flash_attention.cu``,
  built at first use; it also writes the logsumexp ``lse [B, T, H]``) and
  whose backward is :func:`flash_bwd`.  The forward is one launch of one
  of two kernels, which the C side picks from the shape alone: the fused
  one, whole heads of q, k and v in shared memory (T ≤ 64 and D ≤ 32:
  every call the system makes), or the tiled one; ``flash_fwd.last_kernel``
  says which it launched.  The backward at those shapes is one launch of
  the fused backward (delta, dQ, dK and dV of whole heads, planned by
  :func:`flash_bwd_plan`); at other shapes it is ``delta = Σ dO∘O`` as one
  PyTorch reduction, as the JAX package leaves it to XLA, then the tiled
  dQ and dK/dV kernels; ``flash_bwd.last_kernel`` says which.  A shape the
  kernels do not take (:func:`supported`), or a q, k, v, out or dO that is
  not 16-byte aligned (a view at an odd offset; PyTorch allocates on 256
  bytes), raises.
* On CPU tensors it runs :func:`attention_plain`, the dense version that
  mirrors the JAX package's ``attention_reference`` (mask fill
  ``finfo.min``), with PyTorch's autograd.

``flash_fwd.launches``, ``flash_bwd.launches`` (the fused backward),
``flash_dq.launches`` and ``flash_dkv.launches`` (the tiled pair) count
the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
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
        lib.gic_flash_bwd.argtypes = [vp] * 10 + [i] * 5 + [f] + [i] * 3 + [
            vp]
        for fn in (lib.gic_flash_fwd, lib.gic_flash_dq, lib.gic_flash_dkv,
                   lib.gic_flash_bwd):
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


# csrc/flash_attention.cu's fused backward: shapes up to FT_TMAX rows and
# FT_DMAX columns a head; a block of G heads within FB_THREADS threads and
# FB_SMEM bytes, FB_KS threads a row, rows padded by FT_PAD floats, q, k, v
# and dO staged (FB_PLANES tiles; out is read in place) beside the P and dS
# tiles.
FT_TMAX, FT_DMAX, FT_PAD = 64, 32, 4
FB_THREADS, FB_SMEM, FB_KS, FB_PLANES = 256, 96 * 1024, 2, 4


@functools.lru_cache(maxsize=64)
def flash_bwd_plan(T: int, H: int, D: int) -> dict:
    """The backward's route for ``[·, T, H, D]``, from the shape alone:
    ``"fused"`` (T ≤ 64 and D ≤ 32) with ``heads`` (G, the most heads, a
    power of two, that keep a block of one batch row within ``FB_THREADS``
    threads and ``FB_SMEM`` bytes of shared memory), ``threads``, ``smem``
    (bytes: the q, k, v and dO tiles of G heads, rows of ``dp`` +
    ``FT_PAD`` floats, and the P and dS tiles ``[G, T, ld]``), ``dp`` (the
    columns a staged row holds), ``ld`` and ``slices`` (threads a row); or
    ``"tiled"``.  The C side recomputes the geometry (``bwd_geometry``) and
    refuses a launch that differs.  Raises ValueError for a shape no kernel
    takes."""
    if T < 1 or H < 1 or D < 8 or not supported(T, D):
        raise ValueError(f"flash_bwd_plan: unsupported shape T={T} H={H} "
                         f"D={D}")
    if T > FT_TMAX or D > FT_DMAX:
        return {"route": "tiled"}
    dp = 16 if D <= 16 else 32
    ld = T + (2 - T) % 4             # LD % 4 == 2: phase 1's writes
    head = 4 * (FB_PLANES * T * (dp + FT_PAD) + 2 * T * ld)
    g = 1
    while (2 * g <= H and 2 * g * FB_KS * T <= FB_THREADS
           and 2 * g * head <= FB_SMEM):
        g *= 2
    return {"route": "fused", "heads": g,
            "threads": -(-g * FB_KS * T // 32) * 32, "smem": g * head,
            "dp": dp, "ld": ld, "slices": FB_KS}


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


def flash_bwd(q, k, v, out, dout, lse, causal: bool, lengths=None):
    """The backward → ``(dq, dk, dv)``, each ``[B, T, H, D]``, from the
    forward's ``out`` and ``lse`` and the gradient ``dout``.  By
    :func:`flash_bwd_plan`: one launch of the fused backward (delta
    included), counted on ``flash_bwd.launches``; or the tiled route,
    ``delta`` as one PyTorch reduction, then :func:`flash_dq` and
    :func:`flash_dkv`.  ``flash_bwd.last_kernel`` names the route."""
    b, t, h, d = _validate(q, k, v, lengths)
    device = q.device
    _check("out", out, (b, t, h, d), device)
    _check("dout", dout, (b, t, h, d), device)
    _check("lse", lse, (b, t, h), device)
    plan = flash_bwd_plan(t, h, d)
    if plan["route"] == "tiled":
        delta = (dout * out).sum(dim=-1)                # [B, T, H]
        dq = flash_dq(q, k, v, dout, lse, delta, causal, lengths)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, causal, lengths)
        flash_bwd.last_kernel = "tiled"
        return dq, dk, dv
    for name, x in (("out", out), ("dout", dout)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), dout.data_ptr(),
                               lse.data_ptr(), _ptr(lengths), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                               int(causal), 1.0 / math.sqrt(d),
                               plan["heads"], plan["threads"], plan["smem"],
                               _stream(device))
    build.raise_on_error(lib, rc, "flash_attention backward")
    flash_bwd.last_kernel = "fused"
    _count(flash_bwd)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward :func:`flash_bwd`."""

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
        dq, dk, dv = flash_bwd(q, k, v, out, g, lse, ctx.causal, lengths)
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
flash_bwd.launches = 0
flash_bwd.last_kernel = None
flash_dq.launches = 0
flash_dkv.launches = 0
