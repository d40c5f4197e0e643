"""LSTM backward recurrences: the CUDA kernels and their plain versions.

Counterpart of ``gan_image_captioning_tpu/kernels/lstm_bptt.py``:

* :func:`lstm_bptt_chain` (``lstm_bptt_chain``): the decode backward's
  reverse recurrence over all layers, with the inter-layer input gradients
  chained inside each step;
* :func:`lstm_bptt_reverse` (``lstm_bptt_reverse``): one layer's reverse
  recurrence, the backward of the teacher-forced ``lstm_seq_tm``
  (``models/lstm.py:_LayerSeq``), from a saved initial cell state.

Both emit the gate gradients ``d_pre`` for the deferred weight products.
On CUDA tensors each launches its hand-written kernel (``csrc/lstm_bptt.cu``,
built at first use) or raises; on CPU tensors it runs its plain version
(:func:`lstm_bptt_chain_plain`, :func:`lstm_bptt_reverse_plain`).
``lstm_bptt_chain.launches`` and ``lstm_bptt_reverse.launches`` count the
kernel launches (one per call).  Each is one persistent kernel, one
cooperative launch per call (:func:`chain_plan` and :func:`reverse_plan`
size them; ``branches`` on each wrapper counts where its weights came
from).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

_count_lock = threading.Lock()


def _step_grads(gates, c, c_prev, dh, dc):
    """One reverse step of one layer: the gate gradients ``[B, 4H]`` (i, f,
    g, o) from the pre-activation ``gates``, the cell state ``c`` leaving
    the step and ``c_prev`` entering it, the hidden cotangent ``dh`` and
    the carried cell cotangent ``dc``; and the cell cotangent carried on
    to the step before (``dc·f``)."""
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    i_g, f_g = torch.sigmoid(gi), torch.sigmoid(gf)
    g_g, o_g = torch.tanh(gg), torch.sigmoid(go)
    tc = torch.tanh(c)
    do_pre = dh * tc * o_g * (1.0 - o_g)
    dc = dc + dh * o_g * (1.0 - tc * tc)
    di_pre = dc * g_g * i_g * (1.0 - i_g)
    df_pre = dc * c_prev * f_g * (1.0 - f_g)
    dg_pre = dc * i_g * (1.0 - g_g * g_g)
    return torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1), dc * f_g


def lstm_bptt_chain_plain(w_hhs, w_ihs_upper, d_hs, gates, cs):
    """Plain PyTorch version → ``d_pre [T, NL, B, 4H]`` float32 (float32
    or bfloat16 ``gates`` and ``cs``, read as float32)."""
    gates, cs = gates.to(torch.float32), cs.to(torch.float32)
    T, NL, B, H4 = gates.shape
    H = H4 // 4
    dh = [d_hs.new_zeros(B, H) for _ in range(NL)]
    dc = [d_hs.new_zeros(B, H) for _ in range(NL)]
    d_pre = d_hs.new_empty(T, NL, B, H4)
    for t in range(T - 1, -1, -1):
        d_x_upper = None
        for l in range(NL - 1, -1, -1):
            dh_in = d_hs[t] if l == NL - 1 else d_x_upper
            cprev = cs[t - 1, l] if t > 0 else torch.zeros_like(dc[l])
            d, dc[l] = _step_grads(gates[t, l], cs[t, l], cprev,
                                   dh[l] + dh_in, dc[l])
            d_pre[t, l] = d
            dh[l] = d @ w_hhs[l].T
            if l > 0:
                d_x_upper = d @ w_ihs_upper[l - 1].T
    return d_pre


def _check(name, t, shape, device, dtype=torch.float32):
    build.check_tensor("lstm_bptt_chain", name, t, shape, device, dtype)


def _validate(w_hhs, w_ihs_upper, d_hs, gates, cs):
    if gates.ndim != 4 or gates.shape[3] % 4:
        raise ValueError("lstm_bptt_chain: gates must be [T, NL, B, 4H]")
    T, NL, B, H4 = gates.shape
    H = H4 // 4
    device = d_hs.device
    dt = build.compute_dtype("lstm_bptt_chain", gates)
    _check("d_hs", d_hs, (T, B, H), device)
    _check("gates", gates, (T, NL, B, H4), device, dt)
    _check("cs", cs, (T, NL, B, H), device, dt)
    _check("w_hhs", w_hhs, (NL, H, H4), device)
    if NL > 1:
        _check("w_ihs_upper", w_ihs_upper, (NL - 1, H, H4), device)
    return T, NL, B, H


def _library() -> ctypes.CDLL:
    lib = build.load("lstm_bptt")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        # the int after the shape: 1 for the bfloat16 instantiation
        lib.gic_lstm_bptt_chain.argtypes = ([vp] * 5 + [i] * 5 + [vp]
                                            + [ctypes.POINTER(i), vp, vp])
        lib.gic_lstm_bptt_chain.restype = i
        lib.gic_bptt_reverse.argtypes = ([vp] * 5 + [i] * 4 + [vp] * 3
                                         + [ctypes.POINTER(i), vp, vp])
        lib.gic_bptt_reverse.restype = i
        for name in ("gic_reverse_kernel_attrs", "gic_chain_kernel_attrs"):
            getattr(lib, name).argtypes = [i] + [ctypes.POINTER(i)] * 2
            getattr(lib, name).restype = i
        lib._gic_typed = True
    return lib


def lstm_bptt_chain(w_hhs, w_ihs_upper, d_hs, gates, cs):
    """Whole stacked-LSTM decode backward recurrence.

    Args as the JAX ``lstm_bptt_chain``, contiguous:
      w_hhs:       [NL, H, 4H] recurrent weights (``w_hh.T`` per layer).
      w_ihs_upper: [NL-1, H, 4H] input weights of layers 1..NL-1
                   (``w_ih.T``); ignored when NL = 1.
      d_hs:        [T, B, H] top-layer hidden cotangents.
      gates:       [T, NL, B, 4H] saved pre-activation gates.
      cs:          [T, NL, B, H] cell states leaving each step.
    The weights and ``d_hs`` are float32 (the JAX caller casts them);
    ``gates`` and ``cs`` float32, or both bfloat16 (the bfloat16
    decode's residuals: the kernel's bfloat16 instantiation reads them as
    float32).  Returns ``d_pre [T, NL, B, 4H]`` float32.
    """
    T, NL, B, H = _validate(w_hhs, w_ihs_upper, d_hs, gates, cs)
    device = d_hs.device
    if device.type == "cpu":
        return lstm_bptt_chain_plain(w_hhs, w_ihs_upper, d_hs, gates, cs)
    if device.type != "cuda":
        raise ValueError(f"lstm_bptt_chain: unsupported device {device}")
    lib = _library()
    plan = chain_plan(B, H, NL, *build.device_limits(lib, device))
    d_pre = torch.empty(T, NL, B, 4 * H, device=device)
    barrier = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_lstm_bptt_chain(
            w_hhs.data_ptr(), w_ihs_upper.data_ptr() if NL > 1 else None,
            d_hs.data_ptr(), gates.data_ptr(), cs.data_ptr(), T, NL, B, H,
            int(gates.dtype == torch.bfloat16), d_pre.data_ptr(),
            (ctypes.c_int * 5)(*plan["ints"]),
            barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "lstm_bptt_chain")
    with _count_lock:
        lstm_bptt_chain.launches += 1
        if gates.dtype == torch.bfloat16:
            lstm_bptt_chain.bf16_launches += 1
        lstm_bptt_chain.branches[
            "resident" if plan["resident"] else "streamed"] += 1
        lstm_bptt_chain.last_plan = plan
    return d_pre


lstm_bptt_chain.launches = lstm_bptt_chain.bf16_launches = 0
# launches by where the kernel's weight rows came from (as the reverse's)
lstm_bptt_chain.branches = {"resident": 0, "streamed": 0}
lstm_bptt_chain.last_plan = None

# The persistent reverse kernel's geometry (csrc/persistent.cuh,
# csrc/lstm_bptt.cu): 256 threads, a cp.async pool of 4 slots of
# 64 x 132 floats (K tiles in flight), at most 16 units a block.
THREADS = 256
K_TILE = 32
STAGE_BYTES = 4 * 4 * 64 * 132
MAX_UNITS = 16
STATIC_SMEM = 1024          # margin for the kernel's static shared memory
MAX_BLOCKS_PER_SM = 2048 // THREADS


def _kpad(k):
    return -(-k // K_TILE) * K_TILE


def reverse_plan(B: int, H: int, n_sm: int, smem_limit: int,
                 blocks: int = None) -> dict:
    """The persistent reverse kernel's launch plan at batch ``B`` and
    width ``H`` on a card of ``n_sm`` SMs whose blocks may opt into
    ``smem_limit`` bytes of shared memory: ``blocks`` (default one per SM,
    at most one per hidden unit), the hidden units each block owns
    (``units``: ``(j0, j1)`` per block), whether their ``w_hh`` rows stay
    in shared memory for the whole call (``resident``), the dynamic
    shared-memory bytes and the grid barriers per step.  ``ints`` is what
    the C call takes.  Raises ValueError when the work does not fit (more
    than 16 units a block, the carries past the shared memory) or the grid
    cannot be co-resident."""
    for name, v in (("B", B), ("H", H), ("n_sm", n_sm),
                    ("smem_limit", smem_limit)):
        if v < 1:
            raise ValueError(f"reverse_plan: {name} = {v} must be positive")
    grid = min(n_sm, H) if blocks is None else int(blocks)
    if grid < 1:
        raise ValueError(f"reverse_plan: blocks = {grid} must be positive")
    upb = -(-H // grid)
    if upb > MAX_UNITS:
        raise ValueError(f"reverse_plan: {upb} hidden units per block "
                         f"(H = {H} over {grid} blocks) exceed {MAX_UNITS}")
    carries = 4 * 2 * B * upb
    resident_bytes = 4 * upb * (_kpad(4 * H) + 4)
    base = STAGE_BYTES + carries
    resident = base + resident_bytes + STATIC_SMEM <= smem_limit
    smem = base + (resident_bytes if resident else 0)
    if smem + STATIC_SMEM > smem_limit:
        raise ValueError(f"reverse_plan: {smem} bytes of shared memory "
                         f"(B = {B}) exceed the limit {smem_limit}")
    per_sm = min(MAX_BLOCKS_PER_SM, smem_limit // (smem + STATIC_SMEM))
    if grid > per_sm * n_sm:
        raise ValueError(f"reverse_plan: {grid} blocks cannot be "
                         f"co-resident ({per_sm} per SM x {n_sm} SMs)")
    return {"blocks": grid, "threads": THREADS, "units_per_block": upb,
            "units": [(min(b * upb, H), min((b + 1) * upb, H))
                      for b in range(grid)],
            "resident": resident, "smem_bytes": smem,
            "barriers_per_step": 1,
            "ints": (grid, upb, int(resident), smem)}


# The persistent chain kernel's geometry (csrc/lstm_bptt.cu): 256
# threads, a cp.async pool of 3 slots of 72 x 132 floats; a power of two
# units a block, taken in passes of at most 8 weight rows.
CHAIN_STAGE_BYTES = 4 * 3 * 72 * 132


def chain_plan(B: int, H: int, NL: int, n_sm: int, smem_limit: int,
               blocks: int = None) -> dict:
    """The persistent chain kernel's launch plan at batch ``B``, width
    ``H`` and ``NL`` layers on a card of ``n_sm`` SMs whose blocks may opt
    into ``smem_limit`` bytes of shared memory: ``blocks`` (default: as
    many as the hidden units need at the smallest power-of-two units per
    block that one block per SM allows), the hidden units each block owns
    in every layer (``units``), whether its rows of ``w_hhs[l]`` and
    ``w_ihs_upper[l-1]`` stay in shared memory for the whole call
    (``resident``, where they fit beside the pool and the carries of at
    least min(B, 64) batch rows; otherwise they are read from global
    memory each step), the batch rows whose carries (dh, dc of every layer
    and dx_upper) the shared memory left holds (``batch_chunk``: the
    kernel runs the recurrence for one such chunk of rows after another),
    the dynamic shared-memory bytes and the grid barriers per step
    (``NL``).  ``ints`` is what the C call takes.  Raises ValueError when
    not even one row's carries fit or the grid cannot be co-resident."""
    for name, v in (("B", B), ("H", H), ("NL", NL), ("n_sm", n_sm),
                    ("smem_limit", smem_limit)):
        if v < 1:
            raise ValueError(f"chain_plan: {name} = {v} must be positive")
    if blocks is not None and int(blocks) < 1:
        raise ValueError(f"chain_plan: blocks = {blocks} must be positive")
    per_block = -(-H // (min(n_sm, H) if blocks is None else int(blocks)))
    upb = 1 << (per_block - 1).bit_length()
    grid = -(-H // upb) if blocks is None else int(blocks)
    row_bytes = 4 * (2 * NL + 1) * upb          # the carries of one row
    resident_bytes = 4 * upb * (_kpad(4 * H) + 4) * (2 * NL - 1)
    free = smem_limit - STATIC_SMEM - CHAIN_STAGE_BYTES
    resident = (free - resident_bytes) // row_bytes >= min(B, 64)
    if resident:
        free -= resident_bytes
    chunk = min(B, free // row_bytes)
    if chunk < 1:
        raise ValueError(f"chain_plan: the carries of one batch row "
                         f"({row_bytes} bytes) do not fit in the shared "
                         f"memory beside the K-tile pool (limit "
                         f"{smem_limit})")
    smem = (CHAIN_STAGE_BYTES + (resident_bytes if resident else 0)
            + chunk * row_bytes)
    per_sm = min(MAX_BLOCKS_PER_SM, smem_limit // (smem + STATIC_SMEM))
    if grid > per_sm * n_sm:
        raise ValueError(f"chain_plan: {grid} blocks cannot be "
                         f"co-resident ({per_sm} per SM x {n_sm} SMs)")
    return {"blocks": grid, "threads": THREADS, "units_per_block": upb,
            "units": [(min(b * upb, H), min((b + 1) * upb, H))
                      for b in range(grid)],
            "resident": resident, "batch_chunk": chunk,
            "smem_bytes": smem, "barriers_per_step": NL,
            "ints": (grid, upb, int(resident), smem, chunk)}


PROFILE_SLOTS = ("load", "gates", "barrier", "product")


def set_phase_profile(prof, kernel="reverse"):
    """From now on every launch of the ``kernel`` (``"reverse"`` or
    ``"chain"``) adds its block 0's clock64 cycles per phase
    (:data:`PROFILE_SLOTS`) into ``prof`` (an int64 CUDA tensor of 4
    zeros); ``None`` turns it off."""
    fn = getattr(_library(), f"gic_{kernel}_set_profile")
    fn.argtypes = [ctypes.c_void_p]
    fn(None if prof is None else prof.data_ptr())


def kernel_attrs(kernel="reverse", bf16: bool = False):
    """``{"registers": n, "local_bytes": n}`` of the persistent
    ``kernel`` (``"reverse"`` or ``"chain"``), float32 or bfloat16
    instantiation (spills show as local bytes)."""
    lib = _library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    build.raise_on_error(lib, getattr(lib, f"gic_{kernel}_kernel_attrs")(
        int(bf16), ctypes.byref(regs), ctypes.byref(local)),
        "kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


def lstm_bptt_reverse_plain(w_hh, d_hs, gates, c_prev, cs):
    """Plain PyTorch version → ``(d_pre [T, B, 4H], dh0, dc0 [B, H])``
    float32: the JAX package's ``rstep`` (``models/lstm.py:_layer_seq_bwd``)
    over t = T-1 … 0, the carries starting at zero, on its inputs widened
    to float32 (as the TPU kernel's caller casts them)."""
    w_hh, d_hs, gates, c_prev, cs = (t.to(torch.float32) for t in (
        w_hh, d_hs, gates, c_prev, cs))
    T = d_hs.shape[0]
    dh = torch.zeros_like(d_hs[0])
    dc = torch.zeros_like(d_hs[0])
    d_pre = d_hs.new_empty(gates.shape)
    for t in range(T - 1, -1, -1):
        d, dc = _step_grads(gates[t], cs[t], c_prev[t], dh + d_hs[t], dc)
        d_pre[t] = d
        dh = d @ w_hh.T
    return d_pre, dh, dc


def lstm_bptt_reverse(w_hh, d_hs, gates, c_prev, cs):
    """One layer's reverse recurrence.

    Args as the JAX ``lstm_bptt_reverse``, time-major, contiguous, all
    float32 or all bfloat16 (the bfloat16 instantiation widens each as it
    reads it, as the TPU kernel's caller casts them):
      w_hh:   [H, 4H] recurrent weight (``w_hh.T``, the ``w_fused[in:]``
              slice).
      d_hs:   [T, B, H] incoming hidden cotangents.
      gates:  [T, B, 4H] saved pre-activation gates.
      c_prev: [T, B, H] cell states entering each step.
      cs:     [T, B, H] cell states leaving each step.
    Returns ``(d_pre [T, B, 4H], dh0 [B, H], dc0 [B, H])`` float32.
    """
    if d_hs.ndim != 3:
        raise ValueError("lstm_bptt_reverse: d_hs must be [T, B, H]")
    T, B, H = d_hs.shape
    device = d_hs.device
    dt = build.compute_dtype("lstm_bptt_reverse", d_hs)
    for name, t, shape in (("w_hh", w_hh, (H, 4 * H)),
                           ("d_hs", d_hs, (T, B, H)),
                           ("gates", gates, (T, B, 4 * H)),
                           ("c_prev", c_prev, (T, B, H)),
                           ("cs", cs, (T, B, H))):
        build.check_tensor("lstm_bptt_reverse", name, t, shape, device, dt)
    if device.type == "cpu":
        return lstm_bptt_reverse_plain(w_hh, d_hs, gates, c_prev, cs)
    if device.type != "cuda":
        raise ValueError(f"lstm_bptt_reverse: unsupported device {device}")
    lib = _library()
    plan = reverse_plan(B, H, *build.device_limits(lib, device))
    dh0 = torch.empty(B, H, device=device)
    dc0 = torch.empty(B, H, device=device)
    d_pre = torch.empty(T, B, 4 * H, device=device)
    barrier = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_bptt_reverse(
            w_hh.data_ptr(), d_hs.data_ptr(), gates.data_ptr(),
            c_prev.data_ptr(), cs.data_ptr(), T, B, H,
            int(dt == torch.bfloat16), dh0.data_ptr(),
            dc0.data_ptr(), d_pre.data_ptr(),
            (ctypes.c_int * 4)(*plan["ints"]), barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "lstm_bptt_reverse")
    with _count_lock:
        lstm_bptt_reverse.launches += 1
        if dt == torch.bfloat16:
            lstm_bptt_reverse.bf16_launches += 1
        lstm_bptt_reverse.branches[
            "resident" if plan["resident"] else "streamed"] += 1
        lstm_bptt_reverse.last_plan = plan
    return d_pre, dh0, dc0


lstm_bptt_reverse.launches = lstm_bptt_reverse.bf16_launches = 0
# launches by where the kernel's w_hh rows came from: shared memory for
# the whole call ("resident") or global memory each step ("streamed")
lstm_bptt_reverse.branches = {"resident": 0, "streamed": 0}
lstm_bptt_reverse.last_plan = None
