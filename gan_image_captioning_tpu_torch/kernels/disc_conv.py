"""Discriminator conv banks → ReLU → max over time: CUDA kernels and their
plain versions, behind one ``torch.autograd.Function`` per engine.

Counterpart of ``gan_image_captioning_tpu/kernels/disc_conv.py``.  Every
engine's forward keeps only the pooled features and the first argmax over
time of every (column, filter); its backward sends the masked pooled
gradient to that one time row.  The engines (:func:`conv_relu_maxpool`):

* ``"mxu"`` — ``_mxu_fwd_kernel`` / ``_mxu_bwd_dx_kernel``:
  :func:`conv_bank_forward` and :func:`conv_bank_backward`
  (``csrc/disc_conv.cu``); the autograd route masks the pooled gradient
  and sums ``db`` in the backward's launch (:func:`conv_bank_backward_raw`),
  where the JAX package computes them around its kernel (both, and the
  ``pallas`` engine's, also take bfloat16: the bfloat16 instantiation);
* ``"mxu_dxs"`` — the ``mxu`` forward with the DXS backward
  ``_mxu_bwd_kernel`` (the JAX package's ``GIC_MXU_DX=0``):
  :func:`conv_bank_dxs_raw` (``csrc/disc_conv.cu``) writes the per-step
  tap gradients, float32, which :func:`overlap_add` adds into ``d_emb``
  in torch, from the raw pooled gradient, with the mask and ``db`` in its
  launch (:func:`conv_bank_dxs` takes the masked gradients, as the JAX
  kernel does, through the same kernels; the raw route also takes
  bfloat16 inputs);
* ``"pallas"`` — ``_fwd_kernel`` / ``_bwd_kernel``, the per-batch-row
  engine: :func:`conv_rows_forward` and :func:`conv_rows_backward`, the
  ``mxu`` engine's kernels (``csrc/disc_conv.cu``; the backward with the
  mask and ``db`` in the launch) behind counters of their own;
* ``"hybrid"`` — the plain forward (the JAX package leaves it to XLA; in
  bfloat16 with XLA's roundings, :func:`conv_relu_maxpool_hybrid`) with
  the per-batch-row engine's backward;
* ``"plain"`` — the plain versions on any device, for comparisons.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version (:func:`conv_relu_maxpool_plain`,
:func:`conv_bwd_dx_plain`, :func:`conv_dxs_plain`,
:func:`conv_dxs_raw_plain`, :func:`conv_rows_backward_plain`).  Each
wrapper's ``.launches`` counts its calls that launched kernels, one per
call.  A call of
:func:`conv_bank_forward` or :func:`conv_rows_forward` is one launch for
every bank (up to ``FW_MAX_BANKS``, :func:`conv_fwd_plan`); one of
:func:`conv_bank_backward`, :func:`conv_bank_backward_raw` (counted on
``conv_bank_backward``: the same kernels) or :func:`conv_rows_backward` is
one launch for every bank (up to ``BW_MAX_BANKS``) and one reduction of
the dW partials (:func:`conv_bwd_plan`); one of :func:`conv_bank_dxs` or
:func:`conv_bank_dxs_raw` (counted on ``conv_bank_dxs``) is one launch for
every bank at the training width and one reduction
(:func:`conv_dxs_plan`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gan_image_captioning_tpu_torch.kernels import build

_count_lock = threading.Lock()


def fuse_bank_params(convs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     eds: int):
    """Per-bank torch-layout ``(w [n, 1, f, eds], b [n])`` →
    ``(w_all [F, maxf·eds], b_all [F], banks ((n, f), ...))``; a shorter
    filter's missing taps are zero (never read).  Differentiable: gradients
    flow back through the pad and concatenation to each bank."""
    banks = tuple((int(w.shape[0]), int(w.shape[2])) for w, _ in convs)
    maxf = max(f for _, f in banks)
    ws = [F.pad(w.reshape(n, f * eds), (0, (maxf - f) * eds))
          for (w, _), (n, f) in zip(convs, banks)]
    return torch.cat(ws, dim=0), torch.cat([b for _, b in convs]), banks


def _geometry(emb_pad, banks, R: int, eds: int):
    maxf = max(f for _, f in banks)
    b_sz, lp, e_dim = emb_pad.shape
    if e_dim != R * eds:
        raise ValueError(f"disc_conv: embedding width {e_dim} != R·eds = "
                         f"{R}·{eds}")
    L = lp - maxf + 1
    if L < maxf:
        raise ValueError(f"disc_conv: {L} time rows are fewer than the "
                         f"widest filter ({maxf})")
    return b_sz, lp, L


def _bank_weight(w_all, off: int, n: int, f: int, eds: int):
    return w_all[off:off + n, :f * eds].reshape(n, 1, f, eds)


def conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R: int, eds: int,
                            at=None, round_conv: bool = False):
    """Plain version of the forward → ``(pooled [B, R, F], idxs)`` with
    ``idxs[k] [B, R, n_k]`` int32, the first argmax over the real time
    rows.  A convolution over the L real rows (a tap into the zero time
    padding could win the max), ReLU, then max over time.

    ``at`` (a list like ``idxs``) pools at those rows instead; the result
    then also carries the largest amount by which the max over time
    exceeds the value at a given row (0 where the rows are the argmax)
    and how many given rows are not the plain first argmax.

    bfloat16 inputs (the bfloat16 instantiation): widened to float32, the
    convolution, ReLU and max in float32, pooled rounded to bfloat16 at
    the end, as the TPU kernel computes them.  ``round_conv`` (the
    ``hybrid`` engine, whose forward the JAX package leaves to XLA): the
    roundings of XLA's bfloat16 operations instead, the convolution's
    output rounded, the bias added and rounded again, then ReLU and the
    max over the bfloat16 values (first index on ties).  float32: the
    same values either way."""
    _, _, L = _geometry(emb_pad, banks, R, eds)
    dt = emb_pad.dtype
    emb_pad, w_all, b_all = (t.to(torch.float32)
                             for t in (emb_pad, w_all, b_all))
    x = emb_pad[:, None, :L, :]                           # [B, 1, L, E]
    pooled, idxs, off, gap, moved = [], [], 0, 0.0, 0
    for k, (n, f) in enumerate(banks):
        w = _bank_weight(w_all, off, n, f, eds)
        if round_conv and dt != torch.float32:
            z = F.conv2d(x, w, stride=(1, eds)).to(dt).to(torch.float32)
            z = (z + b_all[off:off + n, None, None]).to(dt).to(torch.float32)
            z = torch.relu(z)
        else:
            z = torch.relu(F.conv2d(x, w, b_all[off:off + n],
                                    stride=(1, eds)))
        m, i = z.max(dim=2)                               # first max
        i = i.transpose(1, 2).to(torch.int32).contiguous()  # [B, R, n]
        if at is not None:
            given = at[k].long().transpose(1, 2)[:, :, None]
            v = z.gather(2, given)[:, :, 0]
            gap = max(gap, float((m - v).max()))
            moved += int((at[k] != i).sum())
            m, i = v, at[k]
        pooled.append(m.transpose(1, 2))
        idxs.append(i)
        off += n
    pooled = torch.cat(pooled, dim=2).to(dt).contiguous()
    return (pooled, idxs) if at is None else (pooled, idxs, gap, moved)


def conv_bwd_dx_plain(emb_pad, w_all, banks, R: int, eds: int,
                      idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Plain version of the backward: from the first-argmax rows ``idxs``
    and the ReLU-masked pooled gradients ``dpms[k] [B, R, n_k]`` →
    ``(d_emb_pad [B, Lp, E], dw_all [F, maxf·eds])``: the gradient of the
    convolution taken at the pooled time rows only, float32 (bfloat16
    inputs widened: the TPU kernel accumulates in float32)."""
    _, _, L = _geometry(emb_pad, banks, R, eds)
    emb_pad = emb_pad.to(torch.float32)
    with torch.enable_grad():
        x = emb_pad.detach()[:, None, :L, :].requires_grad_(True)
        w = w_all.detach().to(torch.float32).requires_grad_(True)
        picked, grads, off = [], [], 0
        for (n, f), idx, dpm in zip(banks, idxs, dpms):
            z = F.conv2d(x, _bank_weight(w, off, n, f, eds), stride=(1, eds))
            picked.append(z.gather(2, idx.long().transpose(1, 2)[:, :, None]))
            grads.append(dpm.to(torch.float32).transpose(1, 2)[:, :, None])
            off += n
        d_x, dw_all = torch.autograd.grad(picked, (x, w), grads)
    d_emb = torch.zeros_like(emb_pad)
    d_emb[:, :L] = d_x[:, 0]
    return d_emb, dw_all


def _check(name, t, shape, dtype, device):
    build.check_tensor("disc_conv", name, t, shape, device, dtype)


def _validate(emb_pad, w_all, banks, R, eds, b_all=None, bf16=False):
    """Shapes, devices and dtypes: float32, or bfloat16 throughout where
    the kernel has a bfloat16 instantiation (``bf16``: the forward and the
    raw backward); anything else is a TypeError."""
    if emb_pad.ndim != 3 or not banks:
        raise ValueError("disc_conv: emb_pad must be [B, Lp, E] and banks "
                         "non-empty")
    b_sz, lp, L = _geometry(emb_pad, banks, R, eds)
    maxf = max(f for _, f in banks)
    n_all = sum(n for n, _ in banks)
    device = emb_pad.device
    dt = build.compute_dtype("disc_conv", emb_pad, bf16)
    _check("emb_pad", emb_pad, emb_pad.shape, dt, device)
    _check("w_all", w_all, (n_all, maxf * eds), dt, device)
    if b_all is not None:
        _check("b_all", b_all, (n_all,), dt, device)
    return b_sz, lp, L, n_all


def _library() -> ctypes.CDLL:
    lib = build.load("disc_conv")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        # the int before the stream (forward, DXS backward) / after the
        # mask flag (backward): 1 for the bfloat16 instantiation
        lib.gic_conv_fwd.argtypes = (
            [vp, vp, i, vp] + [i] * 6
            + [ctypes.POINTER(i), ctypes.POINTER(vp), i, i, vp, i, i, vp])
        lib.gic_conv_fwd.restype = i
        lib.gic_conv_bwd.argtypes = (
            [vp, vp] + [i] * 7 + [ctypes.POINTER(i)]
            + [ctypes.POINTER(vp)] * 3 + [i, i, i, ctypes.c_size_t]
            + [vp] * 5)
        lib.gic_conv_bwd.restype = i
        lib.gic_conv_dxs.argtypes = (
            [vp, vp] + [i] * 7 + [ctypes.POINTER(i)]
            + [ctypes.POINTER(vp)] * 3 + [i, ctypes.POINTER(i),
                                          ctypes.c_size_t,
                                          ctypes.POINTER(vp)] + [vp] * 3
            + [i, vp])
        lib.gic_conv_dxs.restype = i
        lib._gic_typed = True
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# csrc/disc_conv.cu:conv_fwd_kernel's geometry: a block of 256 threads owns
# FW_QB columns and FW_NB filters of one bank (4 per thread); a bank of at
# most FW_MAXT taps keeps them in registers, a longer one in shared memory;
# one launch takes up to FW_MAX_BANKS banks.
FW_QB, FW_NB, FW_THREADS, FW_MAXT, FW_MAX_BANKS = 16, 64, 256, 8, 8
SMEM_LIMIT = 232448          # H100: opt-in shared memory per block


def _odd(v: int) -> int:
    return v | 1


def conv_fwd_plan(Q: int, L: int, eds: int, banks,
                  smem_limit: int = SMEM_LIMIT) -> dict:
    """The launches of :func:`conv_bank_forward` for ``Q = B·R`` columns of
    ``L`` real time rows, ``eds`` values a row and ``banks ((n, f), ...)``:
    one per group of up to ``FW_MAX_BANKS`` banks (one for every pass the
    discriminators run).  Each launch lists its banks with their first row
    of ``w_all`` (``off``), their first filter tile (``tile0``; blockIdx.y
    picks the bank), tile count and whether their taps sit in registers;
    its grid ``(column tiles, filter tiles)`` and dynamic shared-memory
    bytes (the columns' rows, and the taps of the banks that do not fit
    in registers).  ``ints`` is what the C call takes per bank.  Raises
    ValueError where a launch's shared memory would pass ``smem_limit``
    or a filter is longer than the rows.  Cached per shape: callers must
    not change the dict."""
    return _conv_fwd_plan(Q, L, eds, tuple(tuple(b) for b in banks),
                          smem_limit)


@functools.lru_cache(maxsize=64)
def _conv_fwd_plan(Q: int, L: int, eds: int, banks, smem_limit: int) -> dict:
    """:func:`conv_fwd_plan`'s work, cached per shape."""
    if Q < 1 or L < 1 or eds < 1 or not banks:
        raise ValueError(f"conv_fwd_plan: Q {Q}, L {L}, eds {eds} and the "
                         "banks must be positive / non-empty")
    launches, off = [], 0
    for g0 in range(0, len(banks), FW_MAX_BANKS):
        group, tile, shared_taps = [], 0, 0
        for n, f in banks[g0:g0 + FW_MAX_BANKS]:
            if n < 1 or not 1 <= f <= L:
                raise ValueError(f"conv_fwd_plan: bank ({n}, {f}) with "
                                 f"{L} rows")
            tiles = -(-n // FW_NB)
            in_regs = f * eds <= FW_MAXT
            if not in_regs:
                shared_taps = max(shared_taps, f * eds)
            group.append({"n": n, "f": f, "off": off, "tile0": tile,
                          "tiles": tiles, "registers": in_regs})
            tile += tiles
            off += n
        smem = 4 * (FW_QB * _odd(L * eds) + shared_taps * FW_NB)
        if smem > smem_limit:
            raise ValueError(f"conv_fwd_plan: {smem} bytes of shared memory "
                             f"pass the limit {smem_limit}")
        launches.append({
            "banks": group, "grid": (-(-Q // FW_QB), tile),
            "smem_bytes": smem,
            "ints": [v for b in group
                     for v in (b["n"], b["f"], b["off"], b["tile0"])]})
    return {"threads": FW_THREADS, "launches": launches}


def conv_bank_forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """Forward of every bank → ``(pooled [B, R, F], idxs)`` as
    :func:`conv_relu_maxpool_plain`: the CUDA kernel on a CUDA tensor (one
    launch for all banks, :func:`conv_fwd_plan`), the plain version on a
    CPU one.  float32, or bfloat16 throughout (pooled bfloat16)."""
    _validate(emb_pad, w_all, banks, R, eds, b_all, bf16=True)
    device = emb_pad.device
    if device.type == "cpu":
        return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    out = _forward(emb_pad, w_all, b_all, banks, R, eds)
    with _count_lock:
        conv_bank_forward.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_bank_forward.bf16_launches += 1
    return out


def _forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """The ``gic_conv_fwd`` launches of :func:`conv_fwd_plan` (one for
    every bank of a pass) → ``(pooled, idxs)``; every output entry is
    written by the kernel."""
    lib = _library()
    b_sz, lp, _ = emb_pad.shape
    L = lp - max(f for _, f in banks) + 1
    n_all, device = w_all.shape[0], emb_pad.device
    plan = conv_fwd_plan(b_sz * R, L, eds, banks)
    pooled = torch.empty(b_sz, R, n_all, dtype=emb_pad.dtype, device=device)
    idxs = [torch.empty(b_sz, R, n, dtype=torch.int32, device=device)
            for n, _ in banks]
    with torch.cuda.device(device):
        for g, launch in enumerate(plan["launches"]):
            nb = len(launch["banks"])
            ints = (ctypes.c_int * (4 * nb))(*launch["ints"])
            ptrs = (ctypes.c_void_p * nb)(*[
                i.data_ptr() for i in idxs[g * FW_MAX_BANKS:][:nb]])
            rc = lib.gic_conv_fwd(
                emb_pad.data_ptr(), w_all.data_ptr(), w_all.shape[1],
                b_all.data_ptr(), b_sz, lp, R, eds, L, nb, ints, ptrs,
                launch["grid"][1], launch["smem_bytes"], pooled.data_ptr(),
                n_all, int(emb_pad.dtype == torch.bfloat16), _stream(device))
            build.raise_on_error(lib, rc, "disc conv forward")
    return pooled, idxs


# csrc/disc_conv.cu:conv_bwd_kernel's tiling, as far as the wrapper needs
# it: a block owns BW_COLS columns of every bank of its launch and leaves
# one row of dW (and db) partials; the filters stream in slabs of BW_SLAB
# of one bank; one launch takes up to BW_MAX_BANKS banks.  The kernel's
# shared memory (and whether a column's rows are accumulated in windows)
# is the C side's own.
BW_COLS, BW_SLAB, BW_MAX_BANKS = 32, 64, 8


def conv_bwd_plan(Q: int, L: int, eds: int, banks, raw: bool = False) -> dict:
    """The launches of the backward of every bank (``csrc/disc_conv.cu:
    gic_conv_bwd``) for ``Q = B·R`` columns of ``L`` real time rows, ``eds``
    values a row and ``banks ((n, f), ...)``: one ``conv_bwd_kernel``
    launch per group of up to ``BW_MAX_BANKS`` banks (one for every pass
    the discriminators run), then one fixed-order reduction of the
    per-block partials.  ``raw``: the gradient is the raw pooled one
    ``[Q, F]`` (masked in the launch, and ``db`` summed:
    :func:`conv_bank_backward_raw`, :func:`conv_rows_backward`) rather
    than one masked tensor per bank (:func:`conv_bank_backward`).

    Each launch lists its banks with their first row of ``w_all``
    (``off``), first slab (``slab0``) and slab count (``BW_SLAB`` filters
    a slab), and whether it adds into ``d_emb`` (``accumulate``: a launch
    after the first); ``slabs`` counts them over all launches.
    ``blocks`` is every launch's grid (column tiles of ``BW_COLS``) and
    the partials' rows, ``slots`` the floats of a row: dW slot ``(k, g)``
    (tap k of filter g) at ``k·F + g``, then, when ``raw``, ``db[g]`` at
    ``ldw·F + g``; the reduction sums each slot over the blocks in block
    order.  ``ints`` is what the C call takes per bank (n, f, off, the row
    stride of its gradient).  The C side checks ``slabs`` and the scratch
    of ``blocks · slots`` floats against its own tiling.
    ``kernel_launches`` counts the launches of a call, the reduction's
    included.  Raises ValueError where a filter is longer than the rows.
    Cached per shape: callers must not change the dict."""
    return _conv_bwd_plan(Q, L, eds, tuple(tuple(b) for b in banks),
                          bool(raw))


@functools.lru_cache(maxsize=64)
def _conv_bwd_plan(Q: int, L: int, eds: int, banks, raw: bool) -> dict:
    """:func:`conv_bwd_plan`'s work, cached per shape."""
    if Q < 1 or L < 1 or eds < 1 or not banks:
        raise ValueError(f"conv_bwd_plan: Q {Q}, L {L}, eds {eds} and the "
                         "banks must be positive / non-empty")
    n_all = sum(n for n, _ in banks)
    ldw = max(f for _, f in banks) * eds
    launches, ints, off, slabs = [], [], 0, 0
    for g0 in range(0, len(banks), BW_MAX_BANKS):
        group, slab = [], 0
        for n, f in banks[g0:g0 + BW_MAX_BANKS]:
            if n < 1 or not 1 <= f <= L:
                raise ValueError(f"conv_bwd_plan: bank ({n}, {f}) with "
                                 f"{L} rows")
            count = -(-n // BW_SLAB)
            group.append({"n": n, "f": f, "off": off, "slab0": slab,
                          "slabs": count})
            ints += [n, f, off, n_all if raw else n]
            slab += count
            off += n
        launches.append({"banks": group, "slabs": slab,
                         "accumulate": g0 > 0})
        slabs += slab
    return {"blocks": -(-Q // BW_COLS), "launches": launches,
            "slabs": slabs, "slots": ldw * n_all + (n_all if raw else 0),
            "ints": ints, "kernel_launches": len(launches) + 1}


def _backward(emb_pad, w_all, banks, R: int, eds: int, idxs, grads,
              pooled=None):
    """One call of ``gic_conv_bwd``, the backward of every bank →
    ``(d_emb, dw_all, db)`` float32: ``grads`` the masked gradient per
    bank, or, with ``pooled``, the raw ``d_pooled [B, R, F]`` (then ``db``
    is summed too; else it is None; the raw route also takes every input
    in bfloat16).  Every output entry is written by the kernels."""
    lib = _library()
    b_sz, lp, e_dim = emb_pad.shape
    L = lp - max(f for _, f in banks) + 1
    raw = pooled is not None
    plan = conv_bwd_plan(b_sz * R, L, eds, banks, raw)
    device = emb_pad.device
    n_all, nb = w_all.shape[0], len(banks)
    f32 = dict(dtype=torch.float32, device=device)
    d_emb = torch.empty(emb_pad.shape, **f32)
    dw_all = torch.empty(w_all.shape, **f32)
    db = torch.empty(n_all, **f32) if raw else None
    part = torch.empty(plan["blocks"] * plan["slots"], **f32)
    vp = ctypes.c_void_p * nb
    if raw:
        offs = [b["off"] for launch in plan["launches"]
                for b in launch["banks"]]
        size = grads.element_size()
        d_ptrs = vp(*[grads.data_ptr() + size * o for o in offs])
        p_ptrs = vp(*[pooled.data_ptr() + size * o for o in offs])
    else:
        d_ptrs, p_ptrs = vp(*[g.data_ptr() for g in grads]), None
    with torch.cuda.device(device):
        rc = lib.gic_conv_bwd(
            emb_pad.data_ptr(), w_all.data_ptr(), w_all.shape[1], b_sz, lp,
            R, eds, L, nb, (ctypes.c_int * (4 * nb))(*plan["ints"]),
            vp(*[i.data_ptr() for i in idxs]), d_ptrs, p_ptrs, int(raw),
            int(emb_pad.dtype == torch.bfloat16), plan["slabs"],
            part.numel(), d_emb.data_ptr(), part.data_ptr(),
            dw_all.data_ptr(), db.data_ptr() if raw else None,
            _stream(device))
        build.raise_on_error(lib, rc, "disc conv backward")
    return d_emb, dw_all, db


def conv_bank_backward(emb_pad, w_all, banks, R: int, eds: int,
                       idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Backward of every bank → ``(d_emb_pad, dw_all)`` as
    :func:`conv_bwd_dx_plain`, from the masked pooled gradients: the CUDA
    kernels on a CUDA tensor (one launch for every bank and one reduction,
    :func:`conv_bwd_plan`), the plain version on a CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds)
    device = emb_pad.device
    for (n, _), idx, dpm in zip(banks, idxs, dpms):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
        _check("dpm", dpm, (b_sz, R, n), torch.float32, device)
    if device.type == "cpu":
        return conv_bwd_dx_plain(emb_pad, w_all, banks, R, eds, idxs, dpms)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    d_emb, dw_all, _ = _backward(emb_pad, w_all, banks, R, eds, idxs, dpms)
    with _count_lock:
        conv_bank_backward.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_bank_backward.bf16_launches += 1
    return d_emb, dw_all


def _check_raw(emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled,
               bf16=True):
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds, bf16=bf16)
    device, dt = emb_pad.device, emb_pad.dtype
    _check("pooled", pooled, (b_sz, R, n_all), dt, device)
    _check("d_pooled", d_pooled, (b_sz, R, n_all), dt, device)
    for (n, _), idx in zip(banks, idxs):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"disc_conv: unsupported device {device}")
    return device.type == "cpu"


def conv_bank_backward_raw(emb_pad, w_all, banks, R: int, eds: int, pooled,
                           idxs: List[torch.Tensor], d_pooled):
    """The ``mxu`` engine's backward from the raw pooled gradient
    ``d_pooled [B, R, F]`` → ``(d_emb_pad, dw_all, db_all)`` as
    :func:`conv_rows_backward_plain`: :func:`conv_bank_backward`'s kernels
    with the ReLU mask and ``db`` in the launch, so the autograd route
    needs no separate mask and sum.  On a CPU tensor, the plain version.
    It launches :func:`conv_bank_backward`'s kernels and counts on
    ``conv_bank_backward.launches``."""
    if _check_raw(emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled):
        return conv_rows_backward_plain(emb_pad, w_all, banks, R, eds, pooled,
                                        idxs, d_pooled)
    out = _backward(emb_pad, w_all, banks, R, eds, idxs, d_pooled, pooled)
    with _count_lock:
        conv_bank_backward.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_bank_backward.bf16_launches += 1
    return out


def conv_dxs_plain(emb_pad, w_all, banks, R: int, eds: int,
                   idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Plain version of the DXS backward → ``(dxss, dw_all)``: per bank the
    per-step tap gradients ``DXS [lv, B·R, f·eds]``, ``DXS[t, q, k] = Σ_n
    [idx[q, n] = t]·dpm[q, n]·w[n, k]``, and ``dw_all [F, maxf·eds]`` — the
    JAX ``_mxu_bwd_kernel``'s arithmetic with a one-hot over time, float32
    (bfloat16 inputs widened, as the TPU kernel reads them)."""
    b_sz, lp, L = _geometry(emb_pad, banks, R, eds)
    emb_pad, w_all = emb_pad.to(torch.float32), w_all.to(torch.float32)
    emb4 = emb_pad.reshape(b_sz, lp, R, eds)
    dw_all = torch.zeros_like(w_all)
    dxss, off = [], 0
    for (n, f), idx, dpm in zip(banks, idxs, dpms):
        lv = L - f + 1
        steps = torch.arange(lv, device=idx.device)[:, None, None]
        dc = torch.where(idx.reshape(1, -1, n) == steps, dpm.reshape(1, -1, n),
                         torch.zeros((), device=dpm.device))  # [lv, Q, n]
        w = w_all[off:off + n, :f * eds]                      # [n, f·eds]
        dxss.append(dc @ w)
        taps = torch.stack([emb4[:, t:t + f].permute(0, 2, 1, 3)
                            .reshape(b_sz * R, f * eds) for t in range(lv)])
        dw_all[off:off + n, :f * eds] = torch.einsum("tqn,tqk->nk", dc, taps)
        off += n
    return dxss, dw_all


def overlap_add(dxss, banks, shape, R: int, eds: int):
    """``d_emb_pad`` of ``shape [B, Lp, R·eds]`` from each bank's DXS: the
    tap j of step t lands on time row t + j (f shifted adds per bank, the
    JAX ``_mxu_vjp_bwd`` without ``GIC_MXU_DX``)."""
    b_sz, lp, _ = shape
    demb = dxss[0].new_zeros(b_sz, lp, R, eds)
    for (_, f), dxs in zip(banks, dxss):
        lv = dxs.shape[0]
        dxs5 = dxs.reshape(lv, b_sz, R, f, eds).permute(1, 0, 2, 3, 4)
        for j in range(f):
            demb[:, j:j + lv] += dxs5[:, :, :, j]
    return demb.reshape(shape)


# csrc/disc_conv.cu:conv_dxs_kernel's geometry: a block owns DX_COLS
# columns (a lane each) of every bank of its launch and a warp per (bank,
# tap) item (round robin past DX_MAX_WARPS); idx, d and pooled stream in
# steps of DX_SLAB filters of every bank, rows of DX_SLD floats, through a
# DX_STAGES-deep ring; each item keeps lv·DX_COLS + 1 floats of
# accumulators.  A launch holds at most DX_MAX_SEGS banks.
DX_COLS, DX_SLAB, DX_SLD, DX_STAGES = 32, 32, 36, 3
DX_MAX_SEGS, DX_MAX_WARPS = 8, 16


def _dxs_smem(L: int, eds: int, ldw: int, segs) -> int:
    """Bytes of shared memory of one launch of ``segs ((n, f, k0, k1),
    ...)``: the ring, the columns' input rows and the items'
    accumulators (``csrc/disc_conv.cu:dxs_smem``)."""
    stage = 3 * DX_COLS * DX_SLD + (DX_SLAB * ldw + 3) // 4 * 4
    acc = sum((k1 - k0) * ((L - f + 1) * DX_COLS + 1)
              for _, f, k0, k1 in segs)
    return 4 * (DX_STAGES * len(segs) * stage + L * eds * DX_COLS + acc)


def conv_dxs_plan(Q: int, L: int, eds: int, banks) -> dict:
    """The launches of the DXS backward of every bank (``csrc/disc_conv.cu:
    gic_conv_dxs``) for ``Q = B·R`` columns of ``L`` real time rows,
    ``eds`` values a row and ``banks ((n, f), ...)``: the (bank, tap)
    items in order, packed into as few ``conv_dxs_kernel`` launches as
    the card's shared memory allows (one at the training width), then one
    fixed-order reduction of the per-block partials (the backward's
    ``conv_bwd_reduce_kernel``) into dW and ``db``.  The gradient is the
    raw pooled one ``[Q, F]``, masked in the launch.

    Each launch lists its segments (``bank``, taps ``[k0, k1)``: a bank's
    taps split over launches only where one launch cannot hold them),
    ``items`` (its (bank, tap) pairs, a warp each up to ``DX_MAX_WARPS``:
    ``threads``), ``steps`` (slabs of ``DX_SLAB`` filters of its largest
    bank) and ``smem_bytes``; ``ints`` is what the C call takes per launch
    (segments, bytes, then per segment bank, k0, k1).  ``blocks`` is
    every launch's grid (column tiles of ``DX_COLS``) and the partials'
    rows, ``slots`` the floats of a row, and ``ints`` what the C call takes
    per bank (n, f, first row, the gradient's row stride), as
    :func:`conv_bwd_plan`'s.
    ``kernel_launches`` counts the launches of a call, the reduction's
    included.  Raises ValueError where a filter is longer than the rows or
    one item's accumulators do not fit.  Cached per shape: callers must
    not change the dict."""
    return _conv_dxs_plan(Q, L, eds, tuple(tuple(b) for b in banks))


@functools.lru_cache(maxsize=64)
def _conv_dxs_plan(Q: int, L: int, eds: int, banks) -> dict:
    """:func:`conv_dxs_plan`'s work, cached per shape."""
    if Q < 1 or L < 1 or eds < 1 or not banks:
        raise ValueError(f"conv_dxs_plan: Q {Q}, L {L}, eds {eds} and the "
                         "banks must be positive / non-empty")
    n_all = sum(n for n, _ in banks)
    ldw = max(f for _, f in banks) * eds
    launches, segs, ints, off = [], [], [], 0

    def smem(sg):  # sg: [(bank, k0, k1), ...]
        return _dxs_smem(L, eds, ldw, [(*banks[b], k0, k1)
                                       for b, k0, k1 in sg])

    def close():
        items, nbytes = sum(k1 - k0 for _, k0, k1 in segs), smem(segs)
        launches.append({
            "segments": [{"bank": b, "k0": k0, "k1": k1}
                         for b, k0, k1 in segs],
            "items": items, "threads": 32 * min(DX_MAX_WARPS, items),
            "steps": max(-(-banks[b][0] // DX_SLAB) for b, _, _ in segs),
            "smem_bytes": nbytes,
            "ints": [len(segs), nbytes] + [v for seg in segs for v in seg]})

    for b, (n, f) in enumerate(banks):
        if n < 1 or not 1 <= f <= L:
            raise ValueError(f"conv_dxs_plan: bank ({n}, {f}) with {L} rows")
        ints += [n, f, off, n_all]
        off += n
        for k in range(f * eds):  # the item (b, k) joins the open launch
            if segs and segs[-1][0] == b:
                grown = segs[:-1] + [(b, segs[-1][1], k + 1)]
            else:
                grown = segs + [(b, k, k + 1)]
            if len(grown) > DX_MAX_SEGS or smem(grown) > SMEM_LIMIT:
                if segs:
                    close()
                grown = [(b, k, k + 1)]
                if smem(grown) > SMEM_LIMIT:
                    raise ValueError(
                        f"conv_dxs_plan: one tap of bank ({n}, {f}) over {L} "
                        f"rows needs more than {SMEM_LIMIT} bytes of shared "
                        "memory")
            segs = grown
    close()
    return {"blocks": -(-Q // DX_COLS), "launches": launches,
            "slots": ldw * n_all + n_all,
            "ints": ints, "kernel_launches": len(launches) + 1}


def _dxs(emb_pad, w_all, banks, R: int, eds: int, idxs, d_pooled, pooled):
    """One call of ``gic_conv_dxs``, the DXS backward of every bank from
    the raw ``d_pooled [B, R, F]`` and ``pooled`` → ``(dxss, dw_all,
    db)``, float32 (the inputs float32, or bfloat16: the bfloat16
    instantiation).  Every output entry is written by the kernels."""
    lib = _library()
    b_sz, lp, _ = emb_pad.shape
    L = lp - max(f for _, f in banks) + 1
    q = b_sz * R
    plan = conv_dxs_plan(q, L, eds, banks)
    device = emb_pad.device
    n_all, nb = w_all.shape[0], len(banks)
    dxss = [torch.empty(L - f + 1, q, f * eds, device=device)
            for _, f in banks]
    dw_all = torch.empty(w_all.shape, device=device)
    db = torch.empty(n_all, device=device)
    size = d_pooled.element_size()
    part = torch.empty(plan["blocks"] * plan["slots"], device=device)
    vp = ctypes.c_void_p * nb
    offs = plan["ints"][2::4]
    ints = [v for launch in plan["launches"] for v in launch["ints"]]
    with torch.cuda.device(device):
        rc = lib.gic_conv_dxs(
            emb_pad.data_ptr(), w_all.data_ptr(), w_all.shape[1], b_sz, lp,
            R, eds, L, nb, (ctypes.c_int * (4 * nb))(*plan["ints"]),
            vp(*[i.data_ptr() for i in idxs]),
            vp(*[d_pooled.data_ptr() + size * o for o in offs]),
            vp(*[pooled.data_ptr() + size * o for o in offs]),
            len(plan["launches"]), (ctypes.c_int * len(ints))(*ints),
            part.numel(), vp(*[x.data_ptr() for x in dxss]), part.data_ptr(),
            dw_all.data_ptr(), db.data_ptr(),
            int(emb_pad.dtype == torch.bfloat16), _stream(device))
        build.raise_on_error(lib, rc, "disc conv DXS backward")
    return dxss, dw_all, db


def conv_bank_dxs(emb_pad, w_all, banks, R: int, eds: int,
                  idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """The DXS backward of every bank from the masked pooled gradients
    (the JAX kernel's inputs) → ``(dxss, dw_all)`` as
    :func:`conv_dxs_plain`: on a CUDA tensor :func:`conv_bank_dxs_raw`'s
    kernels on the gradients side by side, under a mask that passes every
    entry (so the same bits); the plain version on a CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds)
    device = emb_pad.device
    for (n, _), idx, dpm in zip(banks, idxs, dpms):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
        _check("dpm", dpm, (b_sz, R, n), torch.float32, device)
    if device.type == "cpu":
        return conv_dxs_plain(emb_pad, w_all, banks, R, eds, idxs, dpms)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    d_pooled = torch.cat(dpms, dim=-1)
    dxss, dw_all, _ = _dxs(emb_pad, w_all, banks, R, eds, idxs, d_pooled,
                           torch.ones_like(d_pooled))
    with _count_lock:
        conv_bank_dxs.launches += 1
    return dxss, dw_all


def conv_dxs_raw_plain(emb_pad, w_all, banks, R: int, eds: int, pooled,
                       idxs: List[torch.Tensor], d_pooled):
    """Plain version of the DXS backward from the raw pooled gradient
    ``d_pooled [B, R, F]`` → ``(dxss, dw_all, db_all)``: the ReLU mask from
    ``pooled > 0``, ``db`` its masked sum, then :func:`conv_dxs_plain`."""
    dpms, db = _masked(pooled, d_pooled, banks)
    dxss, dw_all = conv_dxs_plain(emb_pad, w_all, banks, R, eds, idxs, dpms)
    return dxss, dw_all, db


def conv_bank_dxs_raw(emb_pad, w_all, banks, R: int, eds: int, pooled,
                      idxs: List[torch.Tensor], d_pooled):
    """The ``mxu_dxs`` engine's backward from the raw pooled gradient →
    ``(dxss, dw_all, db_all)`` as :func:`conv_dxs_raw_plain`:
    the CUDA kernels (one launch for every bank at the training width and
    one reduction, :func:`conv_dxs_plan`) with the ReLU mask and ``db`` in
    the launch, so the autograd route needs no separate mask and sum.  On
    a CPU tensor, the plain version.  float32, or bfloat16 inputs (the
    bfloat16 instantiation; the outputs float32 either way).  Counts on
    ``conv_bank_dxs.launches`` (and ``.bf16_launches``)."""
    if _check_raw(emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled):
        return conv_dxs_raw_plain(emb_pad, w_all, banks, R, eds, pooled,
                                  idxs, d_pooled)
    out = _dxs(emb_pad, w_all, banks, R, eds, idxs, d_pooled, pooled)
    with _count_lock:
        conv_bank_dxs.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_bank_dxs.bf16_launches += 1
    return out


def conv_rows_forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """The per-batch-row engine's forward of every bank → ``(pooled [B, R,
    F], idxs)`` as :func:`conv_relu_maxpool_plain`: on a CUDA tensor the
    kernel of :func:`conv_bank_forward` (``csrc/disc_conv.cu``, one launch
    for every bank, :func:`conv_fwd_plan`), counted on
    ``conv_rows_forward.launches``; the plain version on a CPU one.
    float32, or bfloat16 throughout."""
    _validate(emb_pad, w_all, banks, R, eds, b_all, bf16=True)
    device = emb_pad.device
    if device.type == "cpu":
        return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    out = _forward(emb_pad, w_all, b_all, banks, R, eds)
    with _count_lock:
        conv_rows_forward.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_rows_forward.bf16_launches += 1
    return out


def conv_rows_backward_plain(emb_pad, w_all, banks, R: int, eds: int,
                             pooled, idxs: List[torch.Tensor], d_pooled):
    """Plain version of the per-batch-row backward → ``(d_emb_pad, dw_all,
    db_all)`` from the raw pooled gradient ``d_pooled [B, R, F]``: the ReLU
    mask from ``pooled > 0``, ``db`` its masked sum, and the gradient of the
    convolution at the argmax rows (:func:`conv_bwd_dx_plain`)."""
    dpms, db = _masked(pooled, d_pooled, banks)
    d_emb, dw_all = conv_bwd_dx_plain(emb_pad, w_all, banks, R, eds, idxs,
                                      dpms)
    return d_emb, dw_all, db


def conv_rows_backward(emb_pad, w_all, banks, R: int, eds: int, pooled,
                       idxs: List[torch.Tensor], d_pooled):
    """The per-batch-row engine's backward of every bank as
    :func:`conv_rows_backward_plain`: on a CUDA tensor the kernels of
    :func:`conv_bank_backward_raw` (``csrc/disc_conv.cu``, the mask and
    ``db`` in the launch: one launch for every bank and one reduction,
    :func:`conv_bwd_plan`), counted on ``conv_rows_backward.launches``;
    the plain version on a CPU one."""
    if _check_raw(emb_pad, w_all, banks, R, eds, pooled, idxs, d_pooled):
        return conv_rows_backward_plain(emb_pad, w_all, banks, R, eds, pooled,
                                        idxs, d_pooled)
    out = _backward(emb_pad, w_all, banks, R, eds, idxs, d_pooled, pooled)
    with _count_lock:
        conv_rows_backward.launches += 1
        if emb_pad.dtype == torch.bfloat16:
            conv_rows_backward.bf16_launches += 1
    return out


for _fn in (conv_bank_forward, conv_bank_backward, conv_bank_dxs,
            conv_rows_forward, conv_rows_backward):
    _fn.launches = _fn.bf16_launches = 0

# what argmax_record() collects, in call order: per conv forward its argmax
# rows and pooled values ("pool"), per replayable_relu its input ("relu");
# inside argmax_replay(), a copy of such a record that the plain conv
# forwards and replayable_relu consume, and what each reports
_recorded: Optional[Dict[str, List]] = None
_replay: Optional[Tuple[Dict[str, List], List]] = None


@contextlib.contextmanager
def argmax_record():
    """Collect, in call order, the argmax rows and pooled values of every
    :func:`conv_relu_maxpool` forward run inside the block (every engine)
    and the input of every :func:`replayable_relu`."""
    global _recorded
    prev, _recorded = _recorded, {"pool": [], "relu": []}
    try:
        yield _recorded
    finally:
        _recorded = prev


@contextlib.contextmanager
def argmax_replay(recorded: Dict[str, List]):
    """Inside the block, the plain forwards pool at the ``recorded`` rows
    (from :func:`argmax_record`, in the same call order) rather than at
    their own argmax, and route the pooled gradient where the recorded
    pooled value is positive; :func:`replayable_relu` takes the recorded
    ReLU decisions.  Two routes that sum in another order can disagree
    on a max over time where two rows are within rounding of each other,
    or on a ReLU whose input is within rounding of 0; the replay compares
    them past those ties.  Yields a list of ``(gap, moved)`` per replayed
    call: for a conv forward, the larger of the gap
    :func:`conv_relu_maxpool_plain` reports with ``at`` and the largest
    pooled value of either route where the two disagree on its sign,
    and the rows moved plus those disagreements; for a ReLU, the largest
    |input| of either route where they disagree, and how many do."""
    global _replay
    prev = _replay
    _replay = ({k: list(v) for k, v in recorded.items()}, [])
    try:
        yield _replay[1]
    finally:
        _replay = prev


def _largest(x, where) -> float:
    """The largest entry of ``x`` where ``where`` holds, else 0."""
    return float(x[where].max()) if bool(where.any()) else 0.0


def replayable_relu(x):
    """``torch.relu(x)``; inside :func:`argmax_record` its input is
    recorded, inside :func:`argmax_replay` it is ``x`` where the recorded
    input was positive and 0 elsewhere (the gradient follows the recorded
    decision)."""
    if _replay is not None:
        rec, report = _replay
        was = rec["relu"].pop(0).to(x.dtype)
        want = was > 0
        differ = want != (x > 0)
        report.append((_largest(torch.maximum(was.abs(), x.detach().abs()),
                                differ), int(differ.sum())))
        return torch.where(want, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
    if _recorded is not None:
        _recorded["relu"].append(x.detach())
    return torch.relu(x)


class _ConvReluMaxpool(torch.autograd.Function):
    """Forward: the pooled features; backward: the masked pooled gradient
    routed to its argmax row (the JAX ``_vjp_fwd`` / ``_vjp_bwd`` and
    ``_mxu_vjp_fwd`` / ``_mxu_vjp_bwd``), by ``engine``."""

    @staticmethod
    def forward(ctx, emb_pad, w_all, b_all, banks, R, eds, engine):
        positive = None
        if engine == "plain" and _replay is not None:
            rec, report = _replay
            at, was = rec["pool"].pop(0)
            pooled, idxs, gap, moved = conv_relu_maxpool_plain(
                emb_pad, w_all, b_all, banks, R, eds, at=at)
            # the pooled gradient flows where the recorded route's ReLU let
            # it through
            was = was.to(pooled.dtype)
            positive = was > 0
            differ = positive != (pooled > 0)
            report.append((max(gap, _largest(torch.maximum(was, pooled),
                                             differ)),
                           moved + int(differ.sum())))
        else:
            fwd = _FORWARDS[engine]
            pooled, idxs = fwd(emb_pad, w_all, b_all, banks, R, eds)
        if _recorded is not None:
            _recorded["pool"].append((idxs, pooled.detach()))
        ctx.save_for_backward(emb_pad, w_all, pooled, *idxs)
        ctx.geometry = (banks, R, eds, engine)
        ctx.positive = positive
        return pooled

    @staticmethod
    def backward(ctx, d_pooled):
        emb_pad, w_all, pooled, *idxs = ctx.saved_tensors
        banks, R, eds, engine = ctx.geometry
        if engine in ("mxu", "pallas", "hybrid"):
            # the ReLU mask and db in the backward's launch
            bwd = (conv_bank_backward_raw if engine == "mxu"
                   else conv_rows_backward)
            d_emb, dw_all, db = bwd(emb_pad, w_all, banks, R, eds, pooled,
                                    idxs, d_pooled.contiguous())
        elif engine == "mxu_dxs":  # likewise, then the shifted adds
            dxss, dw_all, db = conv_bank_dxs_raw(emb_pad, w_all, banks, R,
                                                 eds, pooled, idxs,
                                                 d_pooled.contiguous())
            d_emb = overlap_add(dxss, banks, emb_pad.shape, R, eds)
        else:
            dpms, db = _masked(pooled, d_pooled, banks, ctx.positive)
            d_emb, dw_all = conv_bwd_dx_plain(emb_pad, w_all, banks, R, eds,
                                              idxs, dpms)
        # accumulated in float32, rounded to the inputs' dtypes (bfloat16
        # under --dtype bfloat16), as the JAX `_mxu_vjp_bwd` casts them
        return (d_emb.to(emb_pad.dtype), dw_all.to(w_all.dtype),
                db.to(w_all.dtype), None, None, None, None)


def _masked(pooled, d_pooled, banks, positive=None):
    """Per bank, the ReLU-masked pooled gradient ``[B, R, n]``, and the
    bias gradient, as the JAX package computes them around its backward
    kernels (``disc_conv.py:678-682``); ``positive`` (default ``pooled >
    0``) is the mask."""
    if positive is None:
        positive = pooled > 0
    d_pooled = d_pooled.to(torch.float32)
    dpms, db, off = [], [], 0
    for n, _ in banks:
        dpm = torch.where(positive[..., off:off + n],
                          d_pooled[..., off:off + n],
                          torch.zeros((), device=d_pooled.device))
        dpms.append(dpm.contiguous())
        db.append(dpm.sum(dim=(0, 1)))
        off += n
    return dpms, torch.cat(db)


def conv_relu_maxpool_hybrid(emb_pad, w_all, b_all, banks, R: int,
                             eds: int):
    """The ``hybrid`` engine's forward: :func:`conv_relu_maxpool_plain`
    with XLA's roundings of a bfloat16 convolution (``round_conv``), on
    any device: the JAX package leaves this forward to XLA."""
    return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds,
                                   round_conv=True)


_FORWARDS = {"mxu": conv_bank_forward, "mxu_dxs": conv_bank_forward,
             "pallas": conv_rows_forward,
             "hybrid": conv_relu_maxpool_hybrid,
             "plain": conv_relu_maxpool_plain}
ENGINES = tuple(_FORWARDS)


def conv_relu_maxpool(emb_pad, w_all, b_all, banks, R: int, eds: int,
                      engine: str = "mxu"):
    """Pooled conv features ``[B, R, F]`` from the time-padded embeddings
    ``emb_pad [B, Lp, R·eds]`` (``Lp = L + maxf − 1``), through ``engine``
    (one of :data:`ENGINES`; ``"plain"`` runs the plain versions on any
    device, for comparisons on the card)."""
    if engine not in _FORWARDS:
        raise ValueError(f"disc_conv: engine {engine!r}, expected one of "
                         f"{ENGINES}")
    return _ConvReluMaxpool.apply(emb_pad, w_all, b_all, banks, R, eds,
                                  engine)


def pooled_features(convs, emb, eds: int, engine: str = "mxu"):
    """``[B, R, F]`` pooled features from embedded tokens ``emb [B, L, E]``:
    the banks fused, ``maxf − 1`` zero rows of time padding appended, then
    :func:`conv_relu_maxpool`."""
    w_all, b_all, banks = fuse_bank_params(convs, eds)
    maxf = max(f for _, f in banks)
    emb_pad = F.pad(emb, (0, 0, 0, maxf - 1)).contiguous()
    return conv_relu_maxpool(emb_pad, w_all.contiguous(), b_all.contiguous(),
                             banks, emb.shape[-1] // eds, eds, engine)
