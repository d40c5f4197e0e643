"""Discriminator conv banks → ReLU → max over time: CUDA kernels and their
plain versions.

Counterpart of ``gan_image_captioning_tpu/kernels/disc_conv.py``'s MXU
engine (``conv_relu_maxpool_mxu`` with ``_mxu_fwd_kernel`` and
``_mxu_bwd_dx_kernel``).  :func:`conv_relu_maxpool_mxu` keeps the JAX
signature and is a ``torch.autograd.Function``: its forward keeps only the
pooled features and the first argmax over time of every (column, filter);
its backward sends the masked pooled gradient to that one time row.  The
ReLU mask and ``db`` are computed around the backward kernel in torch, as
the JAX package does.

* On CUDA tensors :func:`conv_bank_forward` / :func:`conv_bank_backward`
  launch the hand-written kernels (``csrc/disc_conv.cu``) or raise.
* On CPU tensors they run :func:`conv_relu_maxpool_plain` /
  :func:`conv_bwd_dx_plain` (``torch.nn.functional.conv2d``, and its
  autograd at the pooled positions).

``conv_bank_forward.launches`` and ``conv_bank_backward.launches`` count
the kernel launches (one per call, all banks).
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
        lib._gic_typed = True
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def conv_bank_forward(emb_pad, w_all, b_all, banks, R: int, eds: int):
    """Forward of every bank → ``(pooled [B, R, F], idxs)`` as
    :func:`conv_relu_maxpool_plain`: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU one."""
    b_sz, lp, L, n_all = _validate(emb_pad, w_all, banks, R, eds, b_all)
    device = emb_pad.device
    if device.type == "cpu":
        return conv_relu_maxpool_plain(emb_pad, w_all, b_all, banks, R, eds)
    if device.type != "cuda":
        raise ValueError(f"disc_conv: unsupported device {device}")
    lib = _library()
    ldw = w_all.shape[1]
    pooled = torch.empty(b_sz, R, n_all, device=device)
    idxs, off = [], 0
    with torch.cuda.device(device):
        for n, f in banks:
            idx = torch.empty(b_sz, R, n, dtype=torch.int32, device=device)
            rc = lib.gic_conv_fwd(
                emb_pad.data_ptr(), w_all.data_ptr() + 4 * off * ldw, ldw,
                b_all.data_ptr() + 4 * off, b_sz, lp, R, eds, f, L, n,
                pooled.data_ptr() + 4 * off, n_all, idx.data_ptr(),
                _stream(device))
            build.raise_on_error(lib, rc, "disc conv forward")
            idxs.append(idx)
            off += n
    with _count_lock:
        conv_bank_forward.launches += 1
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


conv_bank_forward.launches = 0
conv_bank_backward.launches = 0

# argmax rows of the forwards inside argmax_record(); the rows the plain
# forwards inside argmax_replay() pool at, and what each such forward
# reports (call order)
_recorded: Optional[List] = None
_replay: Optional[Tuple[List, List]] = None


@contextlib.contextmanager
def argmax_record():
    """Collect, in call order, the argmax rows of every
    :func:`conv_relu_maxpool_mxu` forward run inside the block."""
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
    routed to its argmax row (the JAX ``_mxu_vjp_fwd`` / ``_mxu_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, emb_pad, w_all, b_all, banks, R, eds, plain):
        if plain and _replay is not None:
            rows, report = _replay
            pooled, idxs, gap, moved = conv_relu_maxpool_plain(
                emb_pad, w_all, b_all, banks, R, eds, at=rows.pop(0))
            report.append((gap, moved))
        else:
            fwd = conv_relu_maxpool_plain if plain else conv_bank_forward
            pooled, idxs = fwd(emb_pad, w_all, b_all, banks, R, eds)
        if _recorded is not None:
            _recorded.append(idxs)
        ctx.save_for_backward(emb_pad, w_all, pooled, *idxs)
        ctx.geometry = (banks, R, eds, plain)
        return pooled

    @staticmethod
    def backward(ctx, d_pooled):
        emb_pad, w_all, pooled, *idxs = ctx.saved_tensors
        banks, R, eds, plain = ctx.geometry
        dpms, db, off = [], [], 0
        for n, _ in banks:
            # ReLU mask and bias gradient around the kernel, as the JAX
            # package computes them (disc_conv.py:678-682)
            dpm = torch.where(pooled[..., off:off + n] > 0,
                              d_pooled[..., off:off + n],
                              torch.zeros((), device=d_pooled.device))
            dpms.append(dpm.contiguous())
            db.append(dpm.sum(dim=(0, 1)))
            off += n
        bwd = conv_bwd_dx_plain if plain else conv_bank_backward
        d_emb, dw_all = bwd(emb_pad, w_all, banks, R, eds, idxs, dpms)
        return d_emb, dw_all, torch.cat(db), None, None, None, None


def conv_relu_maxpool_mxu(emb_pad, w_all, b_all, banks, R: int, eds: int,
                          plain: bool = False):
    """Pooled conv features ``[B, R, F]`` from the time-padded embeddings
    ``emb_pad [B, Lp, R·eds]`` (``Lp = L + maxf − 1``), with the kernels'
    backward.  ``plain=True`` runs the plain versions on any device (for
    comparisons on the card)."""
    return _ConvReluMaxpool.apply(emb_pad, w_all, b_all, banks, R, eds,
                                  plain)


def pooled_features(convs, emb, eds: int, plain: bool = False):
    """``[B, R, F]`` pooled features from embedded tokens ``emb [B, L, E]``:
    the banks fused, ``maxf − 1`` zero rows of time padding appended, then
    :func:`conv_relu_maxpool_mxu`."""
    w_all, b_all, banks = fuse_bank_params(convs, eds)
    maxf = max(f for _, f in banks)
    emb_pad = F.pad(emb, (0, 0, 0, maxf - 1)).contiguous()
    return conv_relu_maxpool_mxu(emb_pad, w_all.contiguous(),
                                 b_all.contiguous(), banks,
                                 emb.shape[-1] // eds, eds, plain)
