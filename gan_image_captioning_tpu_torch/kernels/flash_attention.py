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
* On CPU tensors it runs :func:`flash_attention_plain`: in float32
  :func:`attention_plain`, the dense version that mirrors the JAX
  package's ``attention_reference`` (mask fill ``finfo.min``), with
  PyTorch's autograd; in bfloat16 :func:`flash_fwd_plain` and
  :func:`flash_bwd_plain`, the kernels' arithmetic.

bfloat16 (``--dtype bfloat16``): q, k and v bfloat16 take the kernels'
bfloat16 instantiations (the dtype of q, checked against every other
tensor: float32 or bfloat16, TypeError otherwise): the inputs widened
exactly, every score, probability and sum float32 (P is not rounded
before P·V), out, dq, dk and dv rounded once, lse and delta float32 and
delta read from the stored, rounded out; the JAX kernels' arithmetic on
bfloat16 inputs.

``flash_fwd.launches``, ``flash_bwd.launches`` (the fused backward),
``flash_dq.launches`` and ``flash_dkv.launches`` (the tiled pair) count
the kernel launches, and ``.bf16_launches`` the bfloat16 ones among them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

_count_lock = threading.Lock()
NEG = -1e30  # the kernels' finite mask fill (the TPU kernel's _NEG)


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


def _plain_mask(t: int, causal: bool, lengths, device):
    """``[B or 1, 1, T, T]`` True where query i may attend key j."""
    i = torch.arange(t, device=device)
    mask = torch.ones((1, t, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (i[None, :] <= i[:, None])[None]
    if lengths is not None:
        mask = mask & (i[None, None, :]
                       < lengths.to(device)[:, None, None])
    return mask[:, None]


def flash_fwd_plain(q, k, v, causal: bool, lengths=None):
    """The forward kernels' arithmetic in PyTorch → ``(out [B, T, H, D]``
    in q's dtype, ``lse [B, T, H]`` float32): the inputs widened to
    float32, scores ``q·k / √D`` filled with -1e30 where masked,
    ``out = (P·V) / max(l, 1e-30)`` with P unrounded, rounded once, and
    ``lse = m + log(max(l, 1e-30))`` (a row with no valid key: out 0, lse
    about -1e30)."""
    f32 = torch.float32
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * (
        1.0 / math.sqrt(d))
    mask = _plain_mask(t, causal, lengths, q.device)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = (torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32))
           / l_safe.permute(0, 2, 1, 3))
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse.contiguous()


def flash_bwd_plain(q, k, v, out, dout, lse, causal: bool, lengths=None):
    """The backward kernels' arithmetic in PyTorch → ``(dq, dk, dv)`` in
    q's dtype: everything widened to float32, ``P = exp(s - lse)`` where
    unmasked, ``delta = Σ dO∘out`` of the given (stored) out, ``dS = P ∘
    (dO·Vᵀ - delta)``, ``dq = dS·K / √D``, ``dk = dSᵀ·Q / √D``, ``dv =
    Pᵀ·dO``, each rounded once."""
    f32 = torch.float32
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (x.to(f32) for x in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _plain_mask(t, causal, lengths, q.device)
    p = torch.where(mask, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(dim=-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashPlain(torch.autograd.Function):
    """Forward :func:`flash_fwd_plain`; backward :func:`flash_bwd_plain`
    (no kernel: any device)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        out, lse = flash_fwd_plain(q, k, v, causal, lengths)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_bwd_plain(q, k, v, out, g, lse, ctx.causal,
                                     lengths)
        return dq, dk, dv, None, None


def flash_attention_plain(q, k, v, causal: bool, lengths=None):
    """The plain version of :func:`flash_attention`, differentiable, on
    any device: float32 :func:`attention_plain`; bfloat16 the kernels'
    arithmetic (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`)."""
    if q.dtype == torch.bfloat16:
        return _FlashPlain.apply(q, k, v, lengths, bool(causal))
    return attention_plain(q, k, v, causal, lengths)


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_gic_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gic_flash_fwd.argtypes = [vp] * 6 + [i] * 5 + [
            f, i, vp, ctypes.POINTER(i)]
        lib.gic_flash_dq.argtypes = [vp] * 8 + [i] * 5 + [f, i, vp]
        lib.gic_flash_dkv.argtypes = [vp] * 9 + [i] * 5 + [f, i, vp]
        lib.gic_flash_bwd.argtypes = [vp] * 10 + [i] * 5 + [f] + [i] * 4 + [
            vp]
        for fn in (lib.gic_flash_fwd, lib.gic_flash_dq, lib.gic_flash_dkv,
                   lib.gic_flash_bwd):
            fn.restype = i
        lib._gic_typed = True
    return lib


def _count(fn, dtype):
    with _count_lock:
        fn.launches += 1
        if dtype == torch.bfloat16:
            fn.bf16_launches += 1


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
    """Shape, device, alignment and dtype checks → ``(b, t, h, d,
    dtype)``: the dtype of q, float32 or bfloat16, which k and v must
    share."""
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
    dtype = build.compute_dtype("flash_attention", q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (b, t, h, d), device, dtype)
        # the fused forward stages rows by 16-byte copies
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    if lengths is not None:
        _check("lengths", lengths, (b,), device, torch.int32)
    return b, t, h, d, dtype


def flash_fwd(q, k, v, causal: bool, lengths=None):
    """The forward kernel → ``(out [B, T, H, D], lse [B, T, H])``.
    ``flash_fwd.last_kernel`` names the kernel the C side launched:
    ``"fused"`` or ``"tiled"``."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=device)
    lib = _library()
    fused = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gic_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               _ptr(lengths), out.data_ptr(), lse.data_ptr(),
                               b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                               int(dtype == torch.bfloat16), _stream(device),
                               ctypes.byref(fused))
    build.raise_on_error(lib, rc, "flash_attention forward")
    flash_fwd.last_kernel = "fused" if fused.value else "tiled"
    _count(flash_fwd, dtype)
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, causal: bool, lengths=None):
    """The dQ kernel → ``dq [B, T, H, D]``."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    _check("dout", dout, (b, t, h, d), device, dtype)
    _check("lse", lse, (b, t, h), device)
    _check("delta", delta, (b, t, h), device)
    dq = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), _ptr(lengths), dq.data_ptr(),
                              b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                              int(dtype == torch.bfloat16), _stream(device))
    build.raise_on_error(lib, rc, "flash_attention dQ")
    _count(flash_dq, dtype)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool, lengths=None):
    """The dK/dV kernel → ``(dk, dv)``, each ``[B, T, H, D]``."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    _check("dout", dout, (b, t, h, d), device, dtype)
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
                               int(dtype == torch.bfloat16), _stream(device))
    build.raise_on_error(lib, rc, "flash_attention dK/dV")
    _count(flash_dkv, dtype)
    return dk, dv


def flash_bwd(q, k, v, out, dout, lse, causal: bool, lengths=None):
    """The backward → ``(dq, dk, dv)``, each ``[B, T, H, D]``, from the
    forward's ``out`` and ``lse`` and the gradient ``dout``.  By
    :func:`flash_bwd_plan`: one launch of the fused backward (delta
    included), counted on ``flash_bwd.launches``; or the tiled route,
    ``delta`` as one PyTorch reduction, then :func:`flash_dq` and
    :func:`flash_dkv`.  ``flash_bwd.last_kernel`` names the route."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    _check("out", out, (b, t, h, d), device, dtype)
    _check("dout", dout, (b, t, h, d), device, dtype)
    _check("lse", lse, (b, t, h), device)
    plan = flash_bwd_plan(t, h, d)
    if plan["route"] == "tiled":
        # float32 from the stored out, as the JAX package's delta
        delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
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
                               int(dtype == torch.bfloat16), _stream(device))
    build.raise_on_error(lib, rc, "flash_attention backward")
    flash_bwd.last_kernel = "fused"
    _count(flash_bwd, dtype)
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
    Differentiable in q, k and v, float32 or bfloat16.  CUDA tensors go
    through the kernels (or raise), CPU tensors through
    :func:`flash_attention_plain`."""
    b, t, h, d = q.shape
    if not supported(t, d):
        raise ValueError(f"flash_attention: unsupported shape T={t} D={d}")
    build.compute_dtype("flash_attention", q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    lens = None
    if lengths is not None:
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), lens, bool(causal))


for _fn in (flash_fwd, flash_bwd, flash_dq, flash_dkv):
    _fn.launches = _fn.bf16_launches = 0
flash_fwd.last_kernel = flash_bwd.last_kernel = None
