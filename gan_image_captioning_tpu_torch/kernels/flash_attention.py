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
  of two kernels, which :func:`flash_fwd_plan` picks from the shape alone:
  the fused one, whole heads of q, k and v in shared memory (T ≤ 64 and
  D ≤ 64: every call at the default ``--max-seq-len``), or the tiled one
  (a (b, h) and query tile a block walking key tiles, S and P·V on the
  tensor cores in TF32 terms); ``flash_fwd.last_kernel`` says which it
  launched.
  The backward is one launch too, delta included, planned by
  :func:`flash_bwd_plan`: at those shapes the fused backward (dQ, dK and
  dV of whole heads), at any other (the long captions of
  ``--max-seq-len`` past 61, or D > 64) the tiled one (one (b, h) a
  block walking key tiles, tensor-core products);
  ``flash_bwd.last_kernel`` says which.  A shape the
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

``flash_fwd.launches`` and ``flash_bwd.launches`` count the kernel
launches, and ``.bf16_launches`` the bfloat16 ones among them.
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
        lib.gic_flash_fwd.argtypes = [vp] * 6 + [i] * 5 + [f] + [i] * 7 + [
            vp]
        lib.gic_flash_bwd.argtypes = [vp] * 11 + [i] * 5 + [f] + [i] * 5 + [
            vp]
        for fn in (lib.gic_flash_fwd, lib.gic_flash_bwd):
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


# The fused kernels' launch plans.  They are made here, from the shape
# alone, and nowhere else: csrc/flash_attention.cu launches the plan it is
# given after checking it against its layouts and the card (fused_plan_ok).
# The fused kernels take T <= FT_TMAX.  Up to FT_DMAX columns a head, two
# threads a row each take every other key (the key-slice kernels; a staged
# row holds dp = 16 or 32 columns); up to FC_DP, two threads a row each
# take half its columns and every key (the column-half kernels, dp = 64).
# Rows are staged as float32 with FT_PAD floats after each.
FT_TMAX, FT_DMAX, FC_DP, FT_PAD, SLICES = 64, 32, 64, 4, 2
# The tiled backward (csrc/flash_attention.cu: flash_bwd_tiled_kernel, every
# shape the fused kernels do not take): one (b, h) a block of TB_THREADS
# threads, query and key tiles of TB_ROWS rows, P and dS rows of TB_PLD
# floats; staged rows of dp + 4 floats (float32: the plan is sized for it,
# bfloat16's rows of dp + 8 halves are smaller).
TB_ROWS, TB_THREADS, TB_PLD = 32, 128, 36
# The tiled forward (flash_fwd_tiled_kernel, the same shapes): one (b, h) and
# query tile of TF_QROWS rows a block of TB_THREADS threads, 16 rows a warp,
# walking key tiles of TF_KROWS keys, K and V double-buffered; staged rows
# of dp + 4 floats (float32, as above).  The C side builds these tiles only
# and refuses a plan of others.
TF_QROWS, TF_KROWS = 64, 32
# most threads a block (each kernel's launch bounds) and the budget of
# shared memory a block within which G doubles, by direction and design;
# the column-half kernels' budgets give config5's [·, 37, 12, 64] two heads
# a forward block (3 blocks an SM) and one a backward block (4 an SM:
# faster than two heads, 2 an SM, by scripts/flash_fused64_variants.py)
BUDGETS = {("fwd", "keys"): (512, 48 * 1024),
           ("bwd", "keys"): (256, 96 * 1024),
           ("fwd", "columns"): (256, 80 * 1024),
           ("bwd", "columns"): (256, 64 * 1024),
           ("bwd", "tiled"): (TB_THREADS, 113 * 1024)}


def _fused_head(kind: str, T: int, D: int) -> dict:
    """One head's layout in a fused block: ``dp`` (columns a staged row
    holds), ``split`` (what a row's two threads divide: ``"keys"`` or
    ``"columns"``), ``ld`` (the row stride of the backward's P and dS
    tiles, or of the column-half kernels' scores or (p, ds) pairs, in
    their elements) and ``smem`` (bytes)."""
    if D > FT_DMAX:
        ld = T | 1            # odd: a warp's 16 rows write 16 banks
        planes, extra = (4, 2) if kind == "bwd" else (3, 1)
        return {"dp": FC_DP, "split": "columns", "ld": ld,
                "smem": 4 * T * (planes * (FC_DP + FT_PAD) + extra * ld)}
    dp = 16 if D <= 16 else 32
    if kind == "fwd":
        return {"dp": dp, "split": "keys", "ld": None,
                "smem": 4 * 3 * T * (dp + FT_PAD)}
    ld = T + (2 - T) % 4      # LD % 4 == 2: phase 1's writes
    return {"dp": dp, "split": "keys", "ld": ld,
            "smem": 4 * T * (4 * (dp + FT_PAD) + 2 * ld)}


def _tiled_bwd(T: int, D: int) -> dict:
    """The tiled backward's plan: head dim ``dp`` (the power of two ≥ D,
    at least 16), ``threads``, the dQ sums and delta of one (b, h)
    (``ws_floats``: the rows padded to whole query tiles, rows of dp + 4
    floats, then delta) in shared memory where the block then stays within
    its budget (``ws`` = ``"shared"``), else in a scratch of ``ws_floats``
    a (b, h) (``"global"``); ``smem`` bytes."""
    dp = _tiled_dp(D)
    rows = -(-T // TB_ROWS) * TB_ROWS
    ws_floats = rows * (dp + 4) + rows
    tiles = 6 * TB_ROWS * (dp + 4) * 4 + 2 * TB_ROWS * TB_PLD * 4
    most, budget = BUDGETS[("bwd", "tiled")]
    shared = tiles + 4 * ws_floats <= budget
    return {"route": "tiled", "dp": dp, "threads": most,
            "smem": tiles + (4 * ws_floats if shared else 0),
            "ws": "shared" if shared else "global", "ws_floats": ws_floats,
            "rows": TB_ROWS}


def _tiled_dp(D: int) -> int:
    """The tiled kernels' head dim: the power of two ≥ D, at least 16."""
    dp = 16
    while dp < D:
        dp *= 2
    return dp


def _tiled_fwd(T: int, D: int) -> dict:
    """The tiled forward's plan: head dim ``dp``, ``threads``, the query
    tile's ``q_rows`` and the key tiles' ``k_rows``, ``smem`` bytes (the Q
    tile, then two K and two V tiles, rows of dp + 4 floats) and
    ``q_tiles`` (query tiles of a (b, h): a block each)."""
    dp = _tiled_dp(D)
    return {"route": "tiled", "dp": dp, "threads": TB_THREADS,
            "q_rows": TF_QROWS, "k_rows": TF_KROWS,
            "smem": (TF_QROWS + 4 * TF_KROWS) * (dp + 4) * 4,
            "q_tiles": -(-T // TF_QROWS)}


def _plan(kind: str, T: int, H: int, D: int) -> dict:
    if T < 1 or H < 1 or D < 8 or not supported(T, D):
        raise ValueError(f"flash_{kind}_plan: unsupported shape T={T} "
                         f"H={H} D={D}")
    if T > FT_TMAX or D > FC_DP:
        return _tiled_bwd(T, D) if kind == "bwd" else _tiled_fwd(T, D)
    head = _fused_head(kind, T, D)
    most, budget = BUDGETS[(kind, head["split"])]
    g = 1
    while (2 * g <= H and 2 * g * SLICES * T <= most
           and 2 * g * head["smem"] <= budget):
        g *= 2
    return {"route": "fused", "heads": g,
            "threads": -(-g * SLICES * T // 32) * 32,
            "smem": g * head["smem"], "dp": head["dp"],
            "split": head["split"], "ld": head["ld"], "slices": SLICES,
            "most_threads": most}


@functools.lru_cache(maxsize=64)
def flash_fwd_plan(T: int, H: int, D: int) -> dict:
    """The forward's route for ``[·, T, H, D]``, from the shape alone:
    ``"fused"`` (T ≤ 64 and D ≤ 64) with ``heads`` (G, the most heads, a
    power of two, that keep a block of one batch row within its design's
    thread and shared-memory budgets in ``BUDGETS``), ``threads``,
    ``smem`` (bytes: the q, k and v tiles of G heads, rows of ``dp`` +
    ``FT_PAD`` floats, and at D > 32 the scores ``[G, T, ld]``), ``dp``,
    ``split``, ``ld``, ``slices`` (threads a row) and ``most_threads`` (the
    kernel's launch bounds); or ``"tiled"`` (a block a (b, h) and query
    tile; ``dp``, ``threads``, ``q_rows``, ``k_rows``, ``smem`` and
    ``q_tiles`` as :func:`_tiled_fwd` gives them).  Raises ValueError for
    a shape no kernel takes."""
    return _plan("fwd", T, H, D)


@functools.lru_cache(maxsize=64)
def flash_bwd_plan(T: int, H: int, D: int) -> dict:
    """The backward's route for ``[·, T, H, D]``, as
    :func:`flash_fwd_plan` plans the forward: ``"fused"`` (T ≤ 64 and D ≤
    64; the tiles are q, k, v and dO, then P and dS ``[G, T, ld]``, or at
    D > 32 the (p, ds) pairs ``[G, T, ld]``) or ``"tiled"`` (one (b, h) a
    block; ``dp``, ``threads``, ``smem``, ``ws``, ``ws_floats`` and
    ``rows`` as :func:`_tiled_bwd` gives them).  Either is one launch."""
    return _plan("bwd", T, H, D)


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
    """The forward kernel → ``(out [B, T, H, D], lse [B, T, H])``, on
    :func:`flash_fwd_plan`'s route.  ``flash_fwd.last_kernel`` names it:
    ``"fused"`` or ``"tiled"``."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    plan = flash_fwd_plan(t, h, d)
    fused = plan["route"] == "fused"
    out = torch.empty_like(q)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               _ptr(lengths), out.data_ptr(), lse.data_ptr(),
                               b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                               plan["heads"] if fused else 0, plan["dp"],
                               plan.get("q_rows", 0), plan.get("k_rows", 0),
                               plan["threads"], plan["smem"],
                               int(dtype == torch.bfloat16), _stream(device))
    build.raise_on_error(lib, rc, "flash_attention forward")
    flash_fwd.last_kernel = plan["route"]
    _count(flash_fwd, dtype)
    return out, lse


def flash_bwd(q, k, v, out, dout, lse, causal: bool, lengths=None):
    """The backward → ``(dq, dk, dv)``, each ``[B, T, H, D]``, from the
    forward's ``out`` and ``lse`` and the gradient ``dout``: one launch
    (delta included) on :func:`flash_bwd_plan`'s route, the fused kernel
    or the tiled one, counted on ``flash_bwd.launches``;
    ``flash_bwd.last_kernel`` names the route."""
    b, t, h, d, dtype = _validate(q, k, v, lengths)
    device = q.device
    _check("out", out, (b, t, h, d), device, dtype)
    _check("dout", dout, (b, t, h, d), device, dtype)
    _check("lse", lse, (b, t, h), device)
    for name, x in (("out", out), ("dout", dout)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    plan = flash_bwd_plan(t, h, d)
    fused = plan["route"] == "fused"
    scratch = None
    if not fused and plan["ws"] == "global":
        scratch = torch.empty(b * h * plan["ws_floats"], dtype=torch.float32,
                              device=device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.gic_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), dout.data_ptr(),
                               lse.data_ptr(), _ptr(lengths), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), _ptr(scratch),
                               b, t, h, d, int(causal), 1.0 / math.sqrt(d),
                               plan["heads"] if fused else 0, plan["dp"],
                               plan["threads"], plan["smem"],
                               int(dtype == torch.bfloat16), _stream(device))
    build.raise_on_error(lib, rc, "flash_attention backward")
    flash_bwd.last_kernel = plan["route"]
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


for _fn in (flash_fwd, flash_bwd):
    _fn.launches = _fn.bf16_launches = 0
flash_fwd.last_kernel = flash_bwd.last_kernel = None
