"""Discriminator conv banks → ReLU → max over time: CUDA kernels and their
plain versions, behind one ``torch.autograd.Function`` per engine.

Counterpart of ``gan_image_captioning_tpu/kernels/disc_conv.py``.  Every
engine's forward keeps only the pooled features and the first argmax over
time of every (column, filter); its backward sends the masked pooled
gradient to that one time row.  The engines (:func:`conv_relu_maxpool`):

* ``"mxu"`` — ``_mxu_fwd_kernel`` / ``_mxu_bwd_dx_kernel``:
  :func:`conv_bank_forward` and :func:`conv_bank_backward`
  (``csrc/disc_conv.cu``), the ReLU mask and ``db`` in torch around the
  backward, as the JAX package computes them;
* ``"mxu_dxs"`` — the ``mxu`` forward with the DXS backward
  ``_mxu_bwd_kernel`` (the JAX package's ``GIC_MXU_DX=0``):
  :func:`conv_bank_dxs` (``csrc/disc_conv.cu``) writes the per-step tap
  gradients, which :func:`overlap_add` adds into ``d_emb`` in torch;
* ``"pallas"`` — ``_fwd_kernel`` / ``_bwd_kernel``, the per-batch-row
  engine: :func:`conv_rows_forward` and :func:`conv_rows_backward`
  (``csrc/disc_conv_rows.cu``), the mask and the per-row ``dW`` / ``db``
  partials in the kernel, summed in torch;
* ``"hybrid"`` — the plain forward (the JAX package leaves it to XLA) with
  the per-batch-row backward kernel;
* ``"plain"`` — the plain versions on any device, for comparisons.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version (:func:`conv_relu_maxpool_plain`,
:func:`conv_bwd_dx_plain`, :func:`conv_dxs_plain`,
:func:`conv_rows_backward_plain`).  Each wrapper's ``.launches`` counts its
kernel launches: one per call, all banks.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

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
                            at=None):
    """Plain version of the forward → ``(pooled [B, R, F], idxs)`` with
    ``idxs[k] [B, R, n_k]`` int32, the first argmax over the real time
    rows.  A convolution over the L real rows (a tap into the zero time
    padding could win the max), ReLU, then max over time.

    ``at`` (a list like ``idxs``) pools at those rows instead; the result
    then also carries the largest amount by which the max over time
    exceeds the value at a given row (0 where the rows are the argmax)
    and how many given rows are not the plain first argmax."""
    _, _, L = _geometry(emb_pad, banks, R, eds)
    x = emb_pad[:, None, :L, :]                           # [B, 1, L, E]
    pooled, idxs, off, gap, moved = [], [], 0, 0.0, 0
    for k, (n, f) in enumerate(banks):
        z = torch.relu(F.conv2d(x, _bank_weight(w_all, off, n, f, eds),
                                b_all[off:off + n], stride=(1, eds)))
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
    pooled = torch.cat(pooled, dim=2).contiguous()
    return (pooled, idxs) if at is None else (pooled, idxs, gap, moved)


def conv_bwd_dx_plain(emb_pad, w_all, banks, R: int, eds: int,
                      idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Plain version of the backward: from the first-argmax rows ``idxs``
    and the ReLU-masked pooled gradients ``dpms[k] [B, R, n_k]`` →
    ``(d_emb_pad [B, Lp, E], dw_all [F, maxf·eds])``: the gradient of the
    convolution taken at the pooled time rows only."""
    _, _, L = _geometry(emb_pad, banks, R, eds)
    with torch.enable_grad():
        x = emb_pad.detach()[:, None, :L, :].requires_grad_(True)
        w = w_all.detach().requires_grad_(True)
        picked, grads, off = [], [], 0
        for (n, f), idx, dpm in zip(banks, idxs, dpms):
            z = F.conv2d(x, _bank_weight(w, off, n, f, eds), stride=(1, eds))
            picked.append(z.gather(2, idx.long().transpose(1, 2)[:, :, None]))
            grads.append(dpm.transpose(1, 2)[:, :, None])
            off += n
        d_x, dw_all = torch.autograd.grad(picked, (x, w), grads)
    d_emb = torch.zeros_like(emb_pad)
    d_emb[:, :L] = d_x[:, 0]
    return d_emb, dw_all


def _check(name, t, shape, dtype, device):
    build.check_tensor("disc_conv", name, t, shape, device, dtype)


def _validate(emb_pad, w_all, banks, R, eds, b_all=None):
    if emb_pad.ndim != 3 or not banks:
        raise ValueError("disc_conv: emb_pad must be [B, Lp, E] and banks "
                         "non-empty")
    b_sz, lp, L = _geometry(emb_pad, banks, R, eds)
    maxf = max(f for _, f in banks)
    n_all = sum(n for n, _ in banks)
    device = emb_pad.device
    _check("emb_pad", emb_pad, emb_pad.shape, torch.float32, device)
    _check("w_all", w_all, (n_all, maxf * eds), torch.float32, device)
    if b_all is not None:
        _check("b_all", b_all, (n_all,), torch.float32, device)
    return b_sz, lp, L, n_all


def _library() -> ctypes.CDLL:
    lib = build.load("disc_conv")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_conv_bwd_blocks.argtypes = [i]
        lib.gic_conv_bwd_blocks.restype = i
        lib.gic_conv_fwd.argtypes = ([vp, vp, i, vp] + [i] * 7
                                     + [vp, i, vp, vp])
        lib.gic_conv_fwd.restype = i
        lib.gic_conv_bwd.argtypes = [vp, vp, i, vp, vp] + [i] * 7 + [vp] * 3
        lib.gic_conv_bwd.restype = i
        lib.gic_conv_bwd_dxs.argtypes = ([vp, vp, i, vp, vp] + [i] * 7
                                         + [vp] * 3)
        lib.gic_conv_bwd_dxs.restype = i
        lib._gic_typed = True
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def conv_bank_forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """Forward of every bank → ``(pooled [B, R, F], idxs)`` as
    :func:`conv_relu_maxpool_plain`: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU one."""
    _, _, L, n_all = _validate(emb_pad, w_all, banks, R, eds, b_all)
    device = emb_pad.device
    if device.type == "cpu":
        return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _library()
    out = _launch_forward(lib, lib.gic_conv_fwd, "disc conv forward",
                          emb_pad, w_all, b_all, banks, R, eds, L, n_all)
    with _count_lock:
        conv_bank_forward.launches += 1
    return out


def _launch_forward(lib, c_fn, what, emb_pad, w_all, b_all, banks, R, eds,
                    L, n_all):
    """One launch of a forward kernel's C entry ``c_fn`` per bank (both
    forwards take the same arguments) → ``(pooled, idxs)``."""
    device = emb_pad.device
    b_sz, lp = emb_pad.shape[:2]
    ldw = w_all.shape[1]
    pooled = torch.empty(b_sz, R, n_all, device=device)
    idxs, off = [], 0
    with torch.cuda.device(device):
        for n, f in banks:
            idx = torch.empty(b_sz, R, n, dtype=torch.int32, device=device)
            rc = c_fn(
                emb_pad.data_ptr(), w_all.data_ptr() + 4 * off * ldw, ldw,
                b_all.data_ptr() + 4 * off, b_sz, lp, R, eds, f, L, n,
                pooled.data_ptr() + 4 * off, n_all, idx.data_ptr(),
                _stream(device))
            build.raise_on_error(lib, rc, what)
            idxs.append(idx)
            off += n
    return pooled, idxs


def conv_bank_backward(emb_pad, w_all, banks, R: int, eds: int,
                       idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Backward of every bank → ``(d_emb_pad, dw_all)`` as
    :func:`conv_bwd_dx_plain`: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds)
    device = emb_pad.device
    for (n, _), idx, dpm in zip(banks, idxs, dpms):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
        _check("dpm", dpm, (b_sz, R, n), torch.float32, device)
    if device.type == "cpu":
        return conv_bwd_dx_plain(emb_pad, w_all, banks, R, eds, idxs, dpms)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _library()
    ldw = w_all.shape[1]
    q = b_sz * R
    d_emb = torch.zeros_like(emb_pad)
    dw_all = torch.zeros_like(w_all)
    off = 0
    with torch.cuda.device(device):
        for (n, f), idx, dpm in zip(banks, idxs, dpms):
            part = torch.empty(lib.gic_conv_bwd_blocks(q), f * eds, n,
                               device=device)
            rc = lib.gic_conv_bwd(
                emb_pad.data_ptr(), w_all.data_ptr() + 4 * off * ldw, ldw,
                idx.data_ptr(), dpm.data_ptr(), b_sz, lp, R, eds, f, L, n,
                d_emb.data_ptr(), part.data_ptr(), _stream(device))
            build.raise_on_error(lib, rc, "disc conv backward")
            dw_all[off:off + n, :f * eds] = part.sum(dim=0).T
            off += n
    with _count_lock:
        conv_bank_backward.launches += 1
    return d_emb, dw_all


def conv_dxs_plain(emb_pad, w_all, banks, R: int, eds: int,
                   idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """Plain version of the DXS backward → ``(dxss, dw_all)``: per bank the
    per-step tap gradients ``DXS [lv, B·R, f·eds]``, ``DXS[t, q, k] = Σ_n
    [idx[q, n] = t]·dpm[q, n]·w[n, k]``, and ``dw_all [F, maxf·eds]`` — the
    JAX ``_mxu_bwd_kernel``'s arithmetic with a one-hot over time."""
    b_sz, lp, L = _geometry(emb_pad, banks, R, eds)
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


def conv_bank_dxs(emb_pad, w_all, banks, R: int, eds: int,
                  idxs: List[torch.Tensor], dpms: List[torch.Tensor]):
    """The DXS backward of every bank → ``(dxss, dw_all)`` as
    :func:`conv_dxs_plain`: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds)
    device = emb_pad.device
    for (n, _), idx, dpm in zip(banks, idxs, dpms):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
        _check("dpm", dpm, (b_sz, R, n), torch.float32, device)
    if device.type == "cpu":
        return conv_dxs_plain(emb_pad, w_all, banks, R, eds, idxs, dpms)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _library()
    ldw, q = w_all.shape[1], b_sz * R
    dw_all = torch.zeros_like(w_all)
    dxss, off = [], 0
    with torch.cuda.device(device):
        for (n, f), idx, dpm in zip(banks, idxs, dpms):
            dxs = torch.empty(L - f + 1, q, f * eds, device=device)
            part = torch.empty(lib.gic_conv_bwd_blocks(q), f * eds, n,
                               device=device)
            rc = lib.gic_conv_bwd_dxs(
                emb_pad.data_ptr(), w_all.data_ptr() + 4 * off * ldw, ldw,
                idx.data_ptr(), dpm.data_ptr(), b_sz, lp, R, eds, f, L, n,
                dxs.data_ptr(), part.data_ptr(), _stream(device))
            build.raise_on_error(lib, rc, "disc conv DXS backward")
            dw_all[off:off + n, :f * eds] = part.sum(dim=0).T
            dxss.append(dxs)
            off += n
    with _count_lock:
        conv_bank_dxs.launches += 1
    return dxss, dw_all


def _rows_library() -> ctypes.CDLL:
    lib = build.load("disc_conv_rows")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_conv_rows_fwd.argtypes = ([vp, vp, i, vp] + [i] * 7
                                          + [vp, i, vp, vp])
        lib.gic_conv_rows_fwd.restype = i
        lib.gic_conv_rows_bwd.argtypes = ([vp, vp, i, vp, vp, i, vp]
                                          + [i] * 7 + [vp] * 4)
        lib.gic_conv_rows_bwd.restype = i
        lib._gic_typed = True
    return lib


def conv_rows_forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """The per-batch-row forward of every bank → ``(pooled [B, R, F],
    idxs)`` as :func:`conv_relu_maxpool_plain`: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU one."""
    _, _, L, n_all = _validate(emb_pad, w_all, banks, R, eds, b_all)
    device = emb_pad.device
    if device.type == "cpu":
        return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _rows_library()
    out = _launch_forward(lib, lib.gic_conv_rows_fwd,
                          "disc conv rows forward", emb_pad, w_all, b_all,
                          banks, R, eds, L, n_all)
    with _count_lock:
        conv_rows_forward.launches += 1
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
    """The per-batch-row backward of every bank as
    :func:`conv_rows_backward_plain`: the CUDA kernel on a CUDA tensor
    (per-row ``dW`` / ``db`` partials summed here), the plain version on a
    CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds)
    device = emb_pad.device
    _check("pooled", pooled, (b_sz, R, n_all), torch.float32, device)
    _check("d_pooled", d_pooled, (b_sz, R, n_all), torch.float32, device)
    for (n, _), idx in zip(banks, idxs):
        _check("idx", idx, (b_sz, R, n), torch.int32, device)
    if device.type == "cpu":
        return conv_rows_backward_plain(emb_pad, w_all, banks, R, eds, pooled,
                                        idxs, d_pooled)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _rows_library()
    ldw = w_all.shape[1]
    d_emb = torch.zeros_like(emb_pad)
    dw_all = torch.zeros_like(w_all)
    db_all = torch.empty(n_all, device=device)
    off = 0
    with torch.cuda.device(device):
        for (n, f), idx in zip(banks, idxs):
            dw_part = torch.empty(b_sz, f * eds, n, device=device)
            db_part = torch.empty(b_sz, n, device=device)
            rc = lib.gic_conv_rows_bwd(
                emb_pad.data_ptr(), w_all.data_ptr() + 4 * off * ldw, ldw,
                pooled.data_ptr() + 4 * off, d_pooled.data_ptr() + 4 * off,
                n_all, idx.data_ptr(), b_sz, lp, R, eds, f, L, n,
                d_emb.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
                _stream(device))
            build.raise_on_error(lib, rc, "disc conv rows backward")
            dw_all[off:off + n, :f * eds] = dw_part.sum(dim=0).T
            db_all[off:off + n] = db_part.sum(dim=0)
            off += n
    with _count_lock:
        conv_rows_backward.launches += 1
    return d_emb, dw_all, db_all


conv_bank_forward.launches = 0
conv_bank_backward.launches = 0
conv_bank_dxs.launches = 0
conv_rows_forward.launches = 0
conv_rows_backward.launches = 0

# argmax rows of the forwards inside argmax_record(); the rows the plain
# forwards inside argmax_replay() pool at, and what each such forward
# reports (call order)
_recorded: Optional[List] = None
_replay: Optional[Tuple[List, List]] = None


@contextlib.contextmanager
def argmax_record():
    """Collect, in call order, the argmax rows of every
    :func:`conv_relu_maxpool` forward run inside the block (every
    engine)."""
    global _recorded
    prev, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = prev


@contextlib.contextmanager
def argmax_replay(recorded: List):
    """Inside the block, the plain forwards pool at the ``recorded`` rows
    (from :func:`argmax_record`, in the same call order) rather than at
    their own argmax.  Two routes that sum in another order can disagree
    on a max over time where two rows are within rounding of each other;
    the replay compares them past those ties.  Yields a list of
    ``(gap, moved)`` per forward, as :func:`conv_relu_maxpool_plain`
    reports them with ``at``."""
    global _replay
    prev, _replay = _replay, (list(recorded), [])
    try:
        yield _replay[1]
    finally:
        _replay = prev


class _ConvReluMaxpool(torch.autograd.Function):
    """Forward: the pooled features; backward: the masked pooled gradient
    routed to its argmax row (the JAX ``_vjp_fwd`` / ``_vjp_bwd`` and
    ``_mxu_vjp_fwd`` / ``_mxu_vjp_bwd``), by ``engine``."""

    @staticmethod
    def forward(ctx, emb_pad, w_all, b_all, banks, R, eds, engine):
        if engine == "plain" and _replay is not None:
            rows, report = _replay
            pooled, idxs, gap, moved = conv_relu_maxpool_plain(
                emb_pad, w_all, b_all, banks, R, eds, at=rows.pop(0))
            report.append((gap, moved))
        else:
            fwd = _FORWARDS[engine]
            pooled, idxs = fwd(emb_pad, w_all, b_all, banks, R, eds)
        if _recorded is not None:
            _recorded.append(idxs)
        ctx.save_for_backward(emb_pad, w_all, pooled, *idxs)
        ctx.geometry = (banks, R, eds, engine)
        return pooled

    @staticmethod
    def backward(ctx, d_pooled):
        emb_pad, w_all, pooled, *idxs = ctx.saved_tensors
        banks, R, eds, engine = ctx.geometry
        if engine in ("pallas", "hybrid"):
            # the mask, db and the per-row partials in the kernel
            d_emb, dw_all, db = conv_rows_backward(
                emb_pad, w_all, banks, R, eds, pooled, idxs,
                d_pooled.contiguous())
            return d_emb, dw_all, db, None, None, None, None
        dpms, db = _masked(pooled, d_pooled, banks)
        if engine == "mxu_dxs":
            dxss, dw_all = conv_bank_dxs(emb_pad, w_all, banks, R, eds, idxs,
                                         dpms)
            d_emb = overlap_add(dxss, banks, emb_pad.shape, R, eds)
        else:
            bwd = (conv_bwd_dx_plain if engine == "plain"
                   else conv_bank_backward)
            d_emb, dw_all = bwd(emb_pad, w_all, banks, R, eds, idxs, dpms)
        return d_emb, dw_all, db, None, None, None, None


def _masked(pooled, d_pooled, banks):
    """Per bank, the ReLU-masked pooled gradient ``[B, R, n]``, and the
    bias gradient, as the JAX package computes them around its backward
    kernels (``disc_conv.py:678-682``)."""
    dpms, db, off = [], [], 0
    for n, _ in banks:
        dpm = torch.where(pooled[..., off:off + n] > 0,
                          d_pooled[..., off:off + n],
                          torch.zeros((), device=d_pooled.device))
        dpms.append(dpm.contiguous())
        db.append(dpm.sum(dim=(0, 1)))
        off += n
    return dpms, torch.cat(db)


_FORWARDS = {"mxu": conv_bank_forward, "mxu_dxs": conv_bank_forward,
             "pallas": conv_rows_forward,
             "hybrid": conv_relu_maxpool_plain,
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
