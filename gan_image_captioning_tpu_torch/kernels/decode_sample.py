"""Stacked-LSTM free-running decode: the CUDA kernels and their plain
versions.

Counterpart of ``gan_image_captioning_tpu/kernels/decode_sample.py``
(``decode_sample`` in every mode, the carried-state ``serve`` variant,
``decode_sample_q_serve`` and ``decode_sample_embed_bwd``).  One call runs
the whole T-step decode: stacked LSTM gates, vocabulary projection,
first-index argmax and embedding feedback, with

* ``serve``: the per-token greedy log-probability; ``greedy``: ids only;
* ``pretrain`` (:func:`decode_sample_logits`): the greedy ids and the
  logits ``[T, B, V]``;
* ``sample`` (:func:`decode_sample_noise`): ids ``argmax(logits + g)`` and
  the Gumbel noise ``g [T, B, V]``;
* ``sample_resid`` (:func:`decode_sample_resid`): those ids, the soft
  sample ``softmax(temp * (logits + g))`` and the BPTT residuals;
* ``sample_embed`` (:func:`decode_sample_embed`): ``sample_resid`` and the
  soft sample contracted into the discriminator's embedding,
  ``emb = soft @ Wd^T``; :func:`decode_sample_embed_bwd` is its
  generator-side backward (``d_emb`` → ``dWp``, ``dbp``, ``d_htop``).

``serve`` with ``init_state=(h0, c0, x0)`` resumes from a carried state
and returns the state after its last step (the K-step chunks of the
continuous engine and the adaptive decode); :func:`decode_sample_q_serve`
is ``serve`` on an int8 / packed-int4 quantized decoder
(``ops/quantize.py``).

* On CUDA tensors the wrappers launch the hand-written kernels
  (``csrc/decode_serve.cu``, ``csrc/decode_embed_bwd.cu``, built at first
  use) or raise.  Every mode of the dense decode, and the quantized
  serve, is one cooperative launch of one persistent kernel (the time
  loop inside, each block's LSTM weights resident in shared memory;
  quantized weights dequantized in the kernel), sized by
  :func:`persistent_plan`; ``sample_embed`` adds one launch of the
  embedding product.
* On CPU tensors they run the ``*_plain`` functions, the same arithmetic
  as a Python loop of PyTorch operations.  Nothing falls back from one to
  the other.

Launch counters (one per call that reached the card):
``decode_sample.launches`` (serve / greedy, full decode),
``decode_sample_carry.launches`` (serve with carried state),
``decode_sample_logits.launches`` (pretrain), ``decode_sample_noise.
launches`` (sample), ``decode_sample_resid.launches`` (sample_resid),
``decode_sample_embed.launches`` (sample_embed),
``decode_sample_embed_bwd.launches`` and ``decode_sample_q_serve.launches``
(quantized serve, any bits, with or without carry).  ``branches`` counts
the persistent launches (dense and quantized) by the source of the blocks' LSTM weights
(``resident``: shared memory for the whole call; ``streamed``: global
memory each step, where they do not fit) and ``last_plan`` is the plan of
the last one.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import torch

from gan_image_captioning_tpu_torch.kernels import build
from gan_image_captioning_tpu_torch.ops.gumbel import gumbel_noise
# pack_int4_rows is re-exported: the JAX package defines it in this module
from gan_image_captioning_tpu_torch.ops.quantize import (  # noqa: F401
    pack_int4_rows, unpack_int4_rows)

_count_lock = threading.Lock()


def _f32(t):
    """``t`` widened to float32 (a float32 tensor itself)."""
    return t.to(torch.float32)


def _stack_step(lstm_layers, x, h, c):
    """One step of the stacked LSTM: ``h`` and ``c`` (lists, one [B, H]
    per layer) are updated in place; returns the pre-activation gates of
    every layer (both biases).  The TPU kernel's dtypes: the products of
    the weights' dtype (float32 or bfloat16) widened to float32, the bias
    the sum of the two in their dtype, gates and ``c`` float32, ``h`` and
    the next layer's input rounded to the weights' dtype."""
    inp, gates_all = x, []
    for l, p in enumerate(lstm_layers):
        gates = (_f32(inp) @ _f32(p["w_ih"]).T + _f32(h[l]) @ _f32(p["w_hh"]).T
                 + _f32(p["b_ih"] + p["b_hh"]))
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c[l] = torch.sigmoid(gf) * c[l] + torch.sigmoid(gi) * torch.tanh(gg)
        h[l] = (torch.sigmoid(go) * torch.tanh(c[l])).to(p["w_hh"].dtype)
        inp = h[l]
        gates_all.append(gates)
    return gates_all


def _logits(h_top, w_proj, b_proj):
    """float32 logits from h and the projection in their dtype."""
    return _f32(h_top) @ _f32(w_proj).T + _f32(b_proj)


def _zero_state(features, lstm_layers):
    """``h`` zeros in the features' dtype, ``c`` float32 zeros."""
    B = features.shape[0]
    H = lstm_layers[0]["w_hh"].shape[1]
    return ([features.new_zeros(B, H) for _ in lstm_layers],
            [features.new_zeros(B, H, dtype=torch.float32)
             for _ in lstm_layers])


def decode_sample_plain(features, lstm_layers: Sequence[dict], w_proj, b_proj,
                        embed, seq_len: int, init_state=None):
    """Plain PyTorch version → ``(ids [B, T] int32, lps [B, T] f32)``; with
    ``init_state=(h0 [nl, B, H], c0 [nl, B, H] f32, x0 [B, E])`` the
    decode starts there (``features`` unread) and ``(hT, cT, xT)``
    follows.  float32 or bfloat16 weights and features (see
    :func:`_stack_step`); the log-probabilities are float32."""
    if init_state is None:
        (h, c), x = _zero_state(features, lstm_layers), features
    else:
        h, c = list(init_state[0]), list(init_state[1])
        x = init_state[2]
    ids, lps = [], []
    with torch.no_grad():
        for _ in range(seq_len):
            _stack_step(lstm_layers, x, h, c)
            logits = _logits(h[-1], w_proj, b_proj)
            m = logits.max(dim=-1, keepdim=True).values
            lps.append(-torch.log(torch.exp(logits - m).sum(dim=-1)))
            ids_t = torch.argmax(logits, dim=-1)      # first index on ties
            ids.append(ids_t)
            x = embed[ids_t]
    out = (torch.stack(ids, dim=1).to(torch.int32), torch.stack(lps, dim=1))
    if init_state is None:
        return out
    return out + ((torch.stack(h), torch.stack(c), x),)


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
    hs [T, NL, B, H], cs [T, NL, B, H], gates [T, NL, B, 4H])``.  The
    scores and the softmax are float32; soft and the residuals are
    rounded to the features' dtype (bfloat16 under ``--dtype
    bfloat16``)."""
    h, c = _zero_state(features, lstm_layers)
    x, dt = features, features.dtype
    ids, soft, hs, cs, gates_all = [], [], [], [], []
    with torch.no_grad():
        for t in range(seq_len):
            step_gates = _stack_step(lstm_layers, x, h, c)
            scores = (_logits(h[-1], w_proj, b_proj)
                      + gumbel_noise(uniforms[t].shape, u=uniforms[t]))
            ids_t = torch.argmax(scores, dim=-1)      # first index on ties
            ids.append(ids_t)
            soft.append(torch.softmax(scores * temperature, dim=-1).to(dt))
            hs.append(torch.stack(h))
            cs.append(torch.stack(c).to(dt))
            gates_all.append(torch.stack(step_gates).to(dt))
            x = embed[ids_t]
    return (torch.stack(ids, dim=1).to(torch.int32), torch.stack(soft),
            torch.stack(hs), torch.stack(cs), torch.stack(gates_all))


def decode_sample_noise_plain(features, lstm_layers: Sequence[dict], w_proj,
                              b_proj, embed, seq_len: int, uniforms):
    """Plain PyTorch version of mode ``sample`` with the uniforms
    ``[T, B, V]`` given → ``(ids [B, T] int32, noise [T, B, V])``: ids
    ``argmax(logits + g)`` of the float32 scores (first index on ties),
    ``g`` the Gumbel noise of the uniforms, stored in the features' dtype
    (bfloat16 under ``--dtype bfloat16``, as the TPU kernel writes it)."""
    h, c = _zero_state(features, lstm_layers)
    x, ids, noise = features, [], []
    with torch.no_grad():
        for t in range(seq_len):
            _stack_step(lstm_layers, x, h, c)
            g = gumbel_noise(uniforms[t].shape, u=uniforms[t])
            ids_t = torch.argmax(_logits(h[-1], w_proj, b_proj) + g, dim=-1)
            ids.append(ids_t)
            noise.append(g.to(features.dtype))
            x = embed[ids_t]
    return torch.stack(ids, dim=1).to(torch.int32), torch.stack(noise)


def decode_sample_logits_plain(features, lstm_layers: Sequence[dict], w_proj,
                               b_proj, embed, seq_len: int):
    """Plain PyTorch version of mode ``pretrain`` → ``(ids [B, T] int32,
    logits [T, B, V])``: the greedy decode and the logits of every step
    (argmax of the float32 logits; stored in the features' dtype)."""
    h, c = _zero_state(features, lstm_layers)
    x, ids, logits = features, [], []
    with torch.no_grad():
        for _ in range(seq_len):
            _stack_step(lstm_layers, x, h, c)
            logits_t = _logits(h[-1], w_proj, b_proj)
            ids_t = torch.argmax(logits_t, dim=-1)    # first index on ties
            ids.append(ids_t)
            logits.append(logits_t.to(features.dtype))
            x = embed[ids_t]
    return torch.stack(ids, dim=1).to(torch.int32), torch.stack(logits)


def decode_sample_embed_plain(features, lstm_layers: Sequence[dict], w_proj,
                              b_proj, embed, seq_len: int, uniforms,
                              temperature: float, disc_embed):
    """Plain PyTorch version of mode ``sample_embed`` → ``(ids, emb
    [T, B, Ed], soft, hs, cs, gates)``: :func:`decode_sample_resid_plain`
    and ``emb = soft @ disc_embed^T`` (``disc_embed [Ed, V]``), the stored
    soft sample and ``disc_embed`` widened, the sum float32, ``emb``
    rounded to their dtype."""
    ids, soft, hs, cs, gates = decode_sample_resid_plain(
        features, lstm_layers, w_proj, b_proj, embed, seq_len, uniforms,
        temperature)
    with torch.no_grad():
        emb = (_f32(soft) @ _f32(disc_embed).T).to(soft.dtype)
    return ids, emb, soft, hs, cs, gates


def decode_sample_embed_bwd_plain(h_top_tm, soft_tm, d_emb_tm, w_proj,
                                  disc_embed, temperature: float):
    """Plain PyTorch version of :func:`decode_sample_embed_bwd` →
    ``(dWp [H, V], dbp [V], d_htop [T, B, H])``.  bfloat16 inputs: the
    products of the widened operands, d_logits float32 and rounded to
    bfloat16 before the two products that read it, dbp its float32 sum,
    d_htop rounded to bfloat16 (the TPU kernel's ``dl_c``)."""
    T, B, V = soft_tm.shape
    dt = h_top_tm.dtype
    with torch.no_grad():
        d_soft = _f32(d_emb_tm) @ _f32(disc_embed)            # [T, B, V]
        soft = _f32(soft_tm)
        inner = (d_soft * soft).sum(dim=-1, keepdim=True)
        d_logits = (temperature * soft * (d_soft - inner)).reshape(T * B, V)
        dl = _f32(d_logits.to(dt))
        dwp = _f32(h_top_tm).reshape(T * B, -1).T @ dl
        d_htop = (dl @ _f32(w_proj)).reshape(T, B, -1).to(dt)
        return dwp, d_logits.sum(dim=0), d_htop


def _check(name, t, shape, device, dtype=torch.float32):
    build.check_tensor("decode_sample", name, t, shape, device, dtype)


def _validate_batch(fn, features, seq_len):
    if features.ndim != 2:
        raise ValueError(f"{fn}: features must be [B, E]")
    B = features.shape[0]
    if B < 1 or seq_len < 1:
        raise ValueError(f"{fn}: batch {B} and seq_len {seq_len} must be "
                         "positive")


def _validate_state(fn, init_state, nl, B, E, H, device,
                    dtype=torch.float32):
    """``init_state = (h0 [nl, B, H], c0 [nl, B, H], x0 [B, E])``: h0 and
    x0 in the compute ``dtype``, c0 float32."""
    if init_state is None:
        return
    if len(init_state) != 3:
        raise ValueError(f"{fn}: init_state must be (h0, c0, x0)")
    for name, t, shape, dt in zip(("h0", "c0", "x0"), init_state,
                                  ((nl, B, H), (nl, B, H), (B, E)),
                                  (dtype, torch.float32, dtype)):
        build.check_tensor(fn, name, t, shape, device, dt)


def _validate(features, lstm_layers, w_proj, b_proj, embed, seq_len,
              bf16: bool = False):
    """Shapes, devices and dtypes of the decode's arguments: all in the
    features' dtype, float32, or bfloat16 where the mode has a bfloat16
    instantiation (``bf16``); anything else is a TypeError."""
    if not lstm_layers:
        raise ValueError("decode_sample: lstm_layers must be non-empty")
    _validate_batch("decode_sample", features, seq_len)
    B, E = features.shape
    V = embed.shape[0]
    H = lstm_layers[0]["w_hh"].shape[1]
    device = features.device
    dt = build.compute_dtype("decode_sample", features, bf16)
    _check("features", features, (B, E), device, dt)
    _check("embed", embed, (V, E), device, dt)
    _check("w_proj", w_proj, (V, H), device, dt)
    _check("b_proj", b_proj, (V,), device, dt)
    for l, p in enumerate(lstm_layers):
        in_dim = E if l == 0 else H
        _check(f"layer {l} w_ih", p["w_ih"], (4 * H, in_dim), device, dt)
        _check(f"layer {l} w_hh", p["w_hh"], (4 * H, H), device, dt)
        _check(f"layer {l} b_ih", p["b_ih"], (4 * H,), device, dt)
        _check(f"layer {l} b_hh", p["b_hh"], (4 * H,), device, dt)
    return B, E, H, V


def _library() -> ctypes.CDLL:
    lib = build.load("decode_serve")
    if not getattr(lib, "_gic_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        head = [vp] * 4 + [ctypes.POINTER(vp)] + [i] * 6
        tail = [ctypes.POINTER(i), vp, vp]     # plan, barrier, stream
        lib.gic_proj_tile.argtypes = []
        lib.gic_proj_tile.restype = i
        lib.gic_decode_kernel_attrs.argtypes = [i, i] + [ctypes.POINTER(i)] * 2
        lib.gic_decode_kernel_attrs.restype = i
        lib.gic_decode_qserve.argtypes = (
            [vp, ctypes.POINTER(vp)] + [vp] * 5 + [i] * 9 + [vp] * 14
            + tail)
        lib.gic_decode_qserve.restype = i
        # the int after the head of every mode: 1 for the bfloat16
        # instantiation
        for name, args in (
                ("gic_decode_serve", [i] + [vp] * 14),
                ("gic_decode_sample_resid",
                 [i, f, ctypes.c_uint64] + [vp] * 15),
                ("gic_decode_pretrain", [i] + [vp] * 8),
                ("gic_decode_sample", [i, ctypes.c_uint64] + [vp] * 8),
                ("gic_decode_sample_embed",
                 [i, f, ctypes.c_uint64, vp, vp, i] + [vp] * 14)):
            getattr(lib, name).argtypes = head + args + tail
            getattr(lib, name).restype = i
        lib._gic_typed = True
    return lib


# The persistent decode kernel's geometry (csrc/persistent.cuh,
# csrc/decode_serve.cu): 256 threads; a cp.async pool of 18432 floats (K
# tiles in flight: 8 slots for the layers, 4 for the projection), and for
# quantized weights a ring of 5 x 32 x 64 bytes beside it; at most
# 16 hidden units and 8 layers; 64-row
# vocabulary tiles; rows of [x | h] padded to 4 floats per part, to a
# multiple of 32 (K_TILE) in all.
THREADS = 256
K_TILE = 32
STAGE_BYTES = 4 * 4 * 4608
RING_BYTES = 5 * 32 * 64
MAX_UNITS = 16
MAX_LAYERS = 8
PROJ_ROWS = 64
STATIC_SMEM = 4096          # margin for the kernel's static shared memory
MAX_BLOCKS_PER_SM = 2048 // THREADS


def _kpad(k):
    return -(-k // K_TILE) * K_TILE


def _pad4(k):
    return -(-k // 4) * 4


def persistent_plan(B: int, E: int, H: int, V: int, nl: int, n_sm: int,
                    smem_limit: int, blocks: int = None,
                    quantized: bool = False) -> dict:
    """The persistent decode kernel's launch plan for batch ``B``, widths
    ``E``, ``H``, vocabulary ``V`` and ``nl`` layers on a card of ``n_sm``
    SMs whose blocks may opt into ``smem_limit`` bytes of shared memory.

    Returns ``blocks`` (default one per SM, no more than the hidden units
    or vocabulary tiles need), the hidden units (``units``: ``(j0, j1)``
    per block, the same in every layer), vocabulary rows (``vocab_rows``:
    the ``(v0, v1)`` 64-row tiles of each block) and batch rows of the row
    combine (``batch_rows``) that each block owns, whether the blocks'
    gate rows of ``[w_ih | w_hh]`` stay in shared memory for the whole call
    (``resident``; otherwise they are read from global memory each step),
    the dynamic shared-memory bytes (``quantized``: with the projection's
    byte ring), the projection's batch chunk and the grid barriers per
    step.  ``ints`` is what the C call takes.  Raises
    ValueError when the work does not fit (more than 16 units a block or 8
    layers) or the grid cannot be co-resident."""
    for name, v in (("B", B), ("E", E), ("H", H), ("V", V), ("nl", nl),
                    ("n_sm", n_sm), ("smem_limit", smem_limit)):
        if v < 1:
            raise ValueError(f"persistent_plan: {name} = {v} must be "
                             "positive")
    if nl > MAX_LAYERS:
        raise ValueError(f"persistent_plan: {nl} layers exceed "
                         f"{MAX_LAYERS}")
    ntile = -(-V // PROJ_ROWS)
    grid = min(n_sm, max(H, ntile)) if blocks is None else int(blocks)
    if grid < 1:
        raise ValueError(f"persistent_plan: blocks = {grid} must be "
                         "positive")
    upb = -(-H // grid)
    if upb > MAX_UNITS:
        raise ValueError(f"persistent_plan: {upb} hidden units per block "
                         f"(H = {H} over {grid} blocks) exceed {MAX_UNITS}")
    resident_bytes = 4 * sum(
        4 * upb * (_kpad(_pad4(E if l == 0 else H) + _pad4(H)) + 4)
        for l in range(nl))
    stage = STAGE_BYTES + (RING_BYTES if quantized else 0)
    resident = stage + resident_bytes + STATIC_SMEM <= smem_limit
    smem = stage + (resident_bytes if resident else 0)
    if smem + STATIC_SMEM > smem_limit:
        raise ValueError(f"persistent_plan: {smem} bytes of shared memory "
                         f"exceed the limit {smem_limit}")
    per_sm = min(MAX_BLOCKS_PER_SM, smem_limit // (smem + STATIC_SMEM))
    if grid > per_sm * n_sm:
        raise ValueError(f"persistent_plan: {grid} blocks cannot be "
                         f"co-resident ({per_sm} per SM x {n_sm} SMs)")
    pb = 8 if B <= 8 else 16 if B <= 16 else 32 if B <= 32 else 64
    return {"blocks": grid, "threads": THREADS, "units_per_block": upb,
            "units": [(min(b * upb, H), min((b + 1) * upb, H))
                      for b in range(grid)],
            "vocab_rows": [[(t * PROJ_ROWS, min((t + 1) * PROJ_ROWS, V))
                            for t in range(b, ntile, grid)]
                           for b in range(grid)],
            "batch_rows": [list(range(b, B, grid)) for b in range(grid)],
            "resident": resident, "smem_bytes": smem, "proj_batch_chunk": pb,
            "barriers_per_step": nl + 2,
            "ints": (grid, upb, int(resident), pb, smem)}


def kernel_attrs(quantized: bool = False, bf16: bool = False):
    """``{"registers": n, "local_bytes": n}`` of the persistent decode
    kernel, dense or quantized, float32 or bfloat16 (spills show as local
    bytes)."""
    lib = _library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    build.raise_on_error(lib, lib.gic_decode_kernel_attrs(
        int(quantized), int(bf16), ctypes.byref(regs), ctypes.byref(local)),
        "kernel attributes")
    return {"registers": regs.value, "local_bytes": local.value}


PROFILE_SLOTS = ("load", "lstm", "barrier", "proj", "combine")


def set_phase_profile(prof):
    """From now on every launch adds its block 0's clock64 cycles per
    phase (:data:`PROFILE_SLOTS`) into ``prof`` (an int64 CUDA tensor of
    5 zeros); ``None`` turns it off."""
    lib = _library()
    lib.gic_decode_set_profile.argtypes = [ctypes.c_void_p]
    lib.gic_decode_set_profile(None if prof is None else prof.data_ptr())


def _plan_args(lib, device, B, E, H, V, nl, quantized=False):
    """The launch plan on ``device``, its C ints and a barrier counter."""
    plan = persistent_plan(B, E, H, V, nl, *build.device_limits(lib, device),
                           quantized=quantized)
    return (plan, (ctypes.c_int * 5)(*plan["ints"]),
            torch.empty(1, dtype=torch.int32, device=device))


def _layer_pointers(lstm_layers):
    """The ``(w_ih, w_hh, b_ih, b_hh)`` pointer array of the layers (the
    kernel adds the two biases itself)."""
    ptrs = [p[k].data_ptr() for p in lstm_layers
            for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _empty_on(device):
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    return empty


def _ptr(t):
    return None if t is None else t.data_ptr()


def _state_buffers(empty, nl, B, E, H, seq_len, ntile, carry,
                   dtype=torch.float32):
    """Scratch (x, h ping-pong with rows padded to 4 floats, c, per-tile
    statistics; float32), outputs (ids, lps) and, with ``carry``, the
    state outputs (hT and xT in the compute ``dtype``, cT float32)."""
    x, h = _padded(empty, nl, B, E, H)
    bufs = {"x": x, "h": h, "c": empty(nl, B, H),
            "pmax": empty(B, ntile), "psum": empty(B, ntile),
            "pidx": empty(B, ntile, dtype=torch.int32),
            "ids": empty(B, seq_len, dtype=torch.int32),
            "lps": empty(B, seq_len)}
    if carry:
        bufs.update(hT=empty(nl, B, H, dtype=dtype), cT=empty(nl, B, H),
                    xT=empty(B, E, dtype=dtype))
    return bufs


def _outputs(bufs, carry):
    if not carry:
        return bufs["ids"], bufs["lps"]
    return bufs["ids"], bufs["lps"], (bufs["hT"], bufs["cT"], bufs["xT"])


def _count(fn, plan=None, dtype=torch.float32):
    """One launch of ``fn``'s kernel, on ``fn.launches``, and on
    ``fn.bf16_launches`` too where it ran the bfloat16 instantiation."""
    global last_plan
    with _count_lock:
        fn.launches += 1
        if dtype == torch.bfloat16:
            fn.bf16_launches += 1
        if plan is not None:
            branches["resident" if plan["resident"] else "streamed"] += 1
            last_plan = plan


def _launch(features, lstm_layers, w_proj, b_proj, embed, seq_len,
            init_state=None):
    """The serve-mode CUDA kernel: validates, allocates outputs and scratch
    with ``torch.empty`` and runs the decode on the current stream; with
    ``init_state`` it resumes from it and returns the final state too."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    device, dt = features.device, features.dtype
    nl = len(lstm_layers)
    _validate_state("decode_sample", init_state, nl, B, E, H, device, dt)
    carry = init_state is not None
    h0, c0, x0 = init_state if carry else (None, None, None)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl)
    layer_ptrs = _layer_pointers(lstm_layers)
    bufs = _state_buffers(_empty_on(device), nl, B, E, H, seq_len, ntile,
                          carry, dt)
    p = {k: v.data_ptr() for k, v in bufs.items()}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_serve(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            int(dt == torch.bfloat16),
            _ptr(h0), _ptr(c0), _ptr(x0), p["x"], p["h"], p["c"], p["pmax"],
            p["pidx"], p["psum"], p["ids"], p["lps"], p.get("hT"),
            p.get("cT"), p.get("xT"), cplan, barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "decode_serve")
    _count(decode_sample_carry if carry else decode_sample, plan, dt)
    return _outputs(bufs, carry)


def _check_uniforms(uniforms, seq_len, B, V, device, name="uniforms"):
    if uniforms is not None:
        _check(name, uniforms, (seq_len, B, V), device)


def _cpu_uniforms(uniforms, seed, seq_len, B, V, device):
    """The fed uniforms, or the plain versions' seeded draw."""
    if uniforms is None:
        return seeded_uniforms(seed, (seq_len, B, V), device)
    return uniforms


def _require_cuda(device):
    if device.type != "cuda":
        raise ValueError(f"decode_sample: unsupported device {device}")


def _padded(empty, nl, B, E, H):
    """The persistent kernel's x [B, Ep] and h ping-pong [2, nl, B, Hp],
    rows padded to 4 floats (16-byte cp.async)."""
    return empty(B, _pad4(E)), empty(2, nl, B, _pad4(H))


def _sample_scratch(empty, nl, B, E, H, ntile):
    """x and the h ping-pong (:func:`_padded`), c and the sample-mode
    per-tile statistics."""
    return (*_padded(empty, nl, B, E, H), empty(nl, B, H),
            empty(B, ntile), empty(B, ntile, dtype=torch.int32),
            empty(B, ntile), empty(B, ntile))


def decode_sample_resid(features, lstm_layers: Sequence[dict], w_proj,
                        b_proj, embed, seq_len: int, seed: int = 0,
                        temperature: float = 1.0, uniforms=None,
                        uniforms_out=None):
    """Mode ``sample_resid`` → ``(ids [B, T] int32, soft [T, B, V],
    hs [T, NL, B, H], cs [T, NL, B, H], gates [T, NL, B, 4H])``.

    The Gumbel uniforms are ``uniforms [T, B, V]`` when given; otherwise
    the kernel draws them with Philox keyed by ``seed`` (on the CPU:
    ``torch.rand`` from a generator seeded with ``seed``).  A float32
    ``uniforms_out [T, B, V]`` receives the uniforms used.  float32 or
    bfloat16 weights and features (the bfloat16 instantiation: soft and
    the residuals bfloat16, as the TPU kernel writes them)."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    device, dt = features.device, features.dtype
    _check_uniforms(uniforms, seq_len, B, V, device)
    _check_uniforms(uniforms_out, seq_len, B, V, device, "uniforms_out")
    if device.type == "cpu":
        uniforms = _cpu_uniforms(uniforms, seed, seq_len, B, V, device)
        if uniforms_out is not None:
            uniforms_out.copy_(uniforms)
        return decode_sample_resid_plain(features, lstm_layers, w_proj,
                                         b_proj, embed, seq_len, uniforms,
                                         float(temperature))
    _require_cuda(device)
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl)
    layer_ptrs = _layer_pointers(lstm_layers)
    empty = _empty_on(device)
    x, h, c, psmax, psidx, pzmax, pzsum = _sample_scratch(
        empty, nl, B, E, H, ntile)
    bf16 = dt == torch.bfloat16
    zbuf = empty(B, V) if bf16 else None    # z of a step, float32
    ids = empty(B, seq_len, dtype=torch.int32)
    soft = empty(seq_len, B, V, dtype=dt)
    hs = empty(seq_len, nl, B, H, dtype=dt)
    cs = empty(seq_len, nl, B, H, dtype=dt)
    gates = empty(seq_len, nl, B, 4 * H, dtype=dt)
    ptr = _ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_sample_resid(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            int(bf16), float(temperature), int(seed) & (2 ** 64 - 1),
            ptr(uniforms), ptr(uniforms_out), x.data_ptr(), h.data_ptr(),
            c.data_ptr(), psmax.data_ptr(), psidx.data_ptr(),
            pzmax.data_ptr(), pzsum.data_ptr(), ptr(zbuf), ids.data_ptr(),
            soft.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), gates.data_ptr(), cplan, barrier.data_ptr(),
            stream)
    build.raise_on_error(lib, rc, "decode_sample_resid")
    _count(decode_sample_resid, plan, features.dtype)
    return ids, soft, hs, cs, gates


def decode_sample_noise(features, lstm_layers: Sequence[dict], w_proj,
                        b_proj, embed, seq_len: int, seed: int = 0,
                        uniforms=None):
    """Mode ``sample`` → ``(ids [B, T] int32, noise [T, B, V])``: the
    Gumbel-max decode, ``ids = argmax(logits + g)``, and the noise ``g``
    it added.  Uniforms as :func:`decode_sample_resid` (the same Philox
    stream, so the same ``seed`` gives the same ids).  float32 or bfloat16
    weights and features (the bfloat16 instantiation: the scores float32,
    the noise bfloat16)."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    device, dt = features.device, features.dtype
    _check_uniforms(uniforms, seq_len, B, V, device)
    if device.type == "cpu":
        return decode_sample_noise_plain(
            features, lstm_layers, w_proj, b_proj, embed, seq_len,
            _cpu_uniforms(uniforms, seed, seq_len, B, V, device))
    _require_cuda(device)
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl)
    layer_ptrs = _layer_pointers(lstm_layers)
    empty = _empty_on(device)
    x, h, c, psmax, psidx, _, _ = _sample_scratch(empty, nl, B, E, H,
                                                  ntile)
    ids = empty(B, seq_len, dtype=torch.int32)
    noise = empty(seq_len, B, V, dtype=dt)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_sample(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            int(dt == torch.bfloat16), int(seed) & (2 ** 64 - 1),
            _ptr(uniforms), x.data_ptr(),
            h.data_ptr(), c.data_ptr(), psmax.data_ptr(), psidx.data_ptr(),
            ids.data_ptr(), noise.data_ptr(), cplan, barrier.data_ptr(),
            stream)
    build.raise_on_error(lib, rc, "decode_sample_noise")
    _count(decode_sample_noise, plan, dt)
    return ids, noise


def decode_sample_logits(features, lstm_layers: Sequence[dict], w_proj,
                         b_proj, embed, seq_len: int):
    """Mode ``pretrain`` → ``(ids [B, T] int32, logits [T, B, V])``: the
    greedy decode and every step's logits (float32, or the bfloat16
    instantiation's bfloat16 logits)."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    device, dt = features.device, features.dtype
    if device.type == "cpu":
        return decode_sample_logits_plain(features, lstm_layers, w_proj,
                                          b_proj, embed, seq_len)
    _require_cuda(device)
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl)
    layer_ptrs = _layer_pointers(lstm_layers)
    bufs = _state_buffers(_empty_on(device), nl, B, E, H, seq_len, ntile,
                          False)
    logits = torch.empty(seq_len, B, V, dtype=dt, device=device)
    p = {k: v.data_ptr() for k, v in bufs.items()}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_pretrain(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            int(dt == torch.bfloat16), p["x"],
            p["h"], p["c"], p["pmax"], p["pidx"], p["psum"], p["ids"],
            logits.data_ptr(), cplan, barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "decode_sample_logits")
    _count(decode_sample_logits, plan, dt)
    return bufs["ids"], logits


def decode_sample_embed(features, lstm_layers: Sequence[dict], w_proj,
                        b_proj, embed, seq_len: int, disc_embed,
                        seed: int = 0, temperature: float = 1.0,
                        uniforms=None):
    """Mode ``sample_embed`` → ``(ids [B, T] int32, emb [T, B, Ed],
    soft [T, B, V], hs, cs, gates)``: :func:`decode_sample_resid` and the
    soft sample contracted into the discriminator's embedding
    ``disc_embed [Ed, V]`` (torch layout), ``emb = soft @ disc_embed^T``,
    in the same C call.  Uniforms as :func:`decode_sample_resid`.  float32
    or bfloat16 weights, features and ``disc_embed`` (the bfloat16
    instantiation: emb, soft and the residuals bfloat16)."""
    B, E, H, V = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    device, dt = features.device, features.dtype
    if disc_embed is None or disc_embed.ndim != 2:
        raise ValueError("decode_sample: mode 'sample_embed' needs "
                         "disc_embed [Ed, V]")
    Ed = disc_embed.shape[0]
    _check("disc_embed", disc_embed, (Ed, V), device, dt)
    _check_uniforms(uniforms, seq_len, B, V, device)
    if device.type == "cpu":
        return decode_sample_embed_plain(
            features, lstm_layers, w_proj, b_proj, embed, seq_len,
            _cpu_uniforms(uniforms, seed, seq_len, B, V, device),
            float(temperature), disc_embed)
    _require_cuda(device)
    nl = len(lstm_layers)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl)
    layer_ptrs = _layer_pointers(lstm_layers)
    empty = _empty_on(device)
    x, h, c, psmax, psidx, pzmax, pzsum = _sample_scratch(
        empty, nl, B, E, H, ntile)
    bf16 = dt == torch.bfloat16
    zbuf = empty(B, V) if bf16 else None    # z of a step, float32
    ids = empty(B, seq_len, dtype=torch.int32)
    soft = empty(seq_len, B, V, dtype=dt)
    emb = empty(seq_len, B, Ed, dtype=dt)
    hs = empty(seq_len, nl, B, H, dtype=dt)
    cs = empty(seq_len, nl, B, H, dtype=dt)
    gates = empty(seq_len, nl, B, 4 * H, dtype=dt)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_sample_embed(
            features.data_ptr(), embed.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), layer_ptrs, B, E, H, V, nl, seq_len,
            int(bf16), float(temperature), int(seed) & (2 ** 64 - 1),
            _ptr(uniforms), disc_embed.data_ptr(), Ed, x.data_ptr(),
            h.data_ptr(), c.data_ptr(), psmax.data_ptr(), psidx.data_ptr(),
            pzmax.data_ptr(), pzsum.data_ptr(), _ptr(zbuf), ids.data_ptr(),
            soft.data_ptr(), hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            emb.data_ptr(), cplan, barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "decode_sample_embed")
    _count(decode_sample_embed, plan, dt)
    return ids, emb, soft, hs, cs, gates


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("decode_embed_bwd")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_decode_embed_bwd.argtypes = (
            [vp] * 5 + [i] * 5 + [ctypes.c_float, ctypes.POINTER(i)]
            + [vp] * 5)
        lib.gic_decode_embed_bwd.restype = i
        lib._gic_typed = True
    return lib


# The tiles (M, N, K) of csrc/decode_embed_bwd.cu's two products that are
# split over K = V (SE_* and HT_* there): se = soft @ wd^T and d_htop.  They
# steer the choice of splits only; the C side refuses a chunk that is not a
# whole number of its K tiles.  EB_DL_ROWS: the rows of a d_logits block
# (DL_BM), whose column sums the bfloat16 backward keeps for dbp.
EB_SE_TILE, EB_HTOP_TILE, EB_MAX_SPLIT = (128, 64, 32), (128, 128, 64), 32
EB_DL_ROWS = 64
# The bfloat16 backward's tiles of the same two products, both on wgmma
# with K tiles of 64 (WG_BK there): se in 128 x 64 blocks, two an SM;
# d_htop in 128 x 256 blocks, one an SM.  Its splits stay within one wave
# of blocks: a split more only adds partial sums to write and reduce.
EB_BF16_TILES = {"se": ((128, 64, 64), 2), "d_htop": ((128, 256, 64), 1)}


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _split_k(tiles: int, K: int, bk: int, slots: int,
             max_split: int = EB_MAX_SPLIT):
    """``(splits, chunk)``: K cut into chunks of whole K tiles of ``bk`` so
    that the blocks (``tiles`` per split, ``slots`` at a time on the card)
    take the fewest waves × K tiles per block; the fewest splits among
    equals."""
    k_tiles = -(-K // bk)
    best = None
    for s in range(1, min(k_tiles, max_split) + 1):
        chunk = -(-k_tiles // s)
        s = -(-k_tiles // chunk)
        cost = -(-tiles * s // slots) * chunk
        if best is None or cost < best[0]:
            best = (cost, s, chunk * bk)
    return best[1], best[2]


@functools.lru_cache(maxsize=64)
def embed_bwd_plan(R: int, H: int, V: int, Ed: int, n_sm: int,
                   bf16: bool = False) -> dict:
    """The splits of :func:`decode_sample_embed_bwd` for ``R = T·B`` rows
    on a card of ``n_sm`` SMs: ``se [R, Ed]`` and ``d_htop [R, H]``, both
    sums over V, each with its output ``tiles`` and V cut into ``splits``
    chunks of ``chunk``; the scratch floats (float32: d_logits, inner, the
    se partials and, when split, the d_htop partials; ``bf16``: the
    bfloat16 d_logits, inner, the se partials, the column sums of each
    ``EB_DL_ROWS`` rows and the d_htop partials, split or not; each from a
    multiple of 4 floats); the launches of one call (float32: five, six
    where d_htop is split; bfloat16: six, dbp summed in the dWp launch);
    ``ints``, what the C call takes.  Cached per shape: callers must not
    change the dict."""
    for name, v in (("R", R), ("H", H), ("V", V), ("Ed", Ed),
                    ("n_sm", n_sm)):
        if v < 1:
            raise ValueError(f"embed_bwd_plan: {name} = {v} must be "
                             "positive")
    plan = {}
    for name, N in (("se", Ed), ("d_htop", H)):
        (bm, bn, bk), per_sm = (EB_BF16_TILES[name] if bf16 else
                                ({"se": EB_SE_TILE,
                                  "d_htop": EB_HTOP_TILE}[name], 1))
        tiles = -(-R // bm) * -(-N // bn)
        slots = n_sm * per_sm
        splits, chunk = _split_k(tiles, V, bk, slots,
                                 max(1, min(EB_MAX_SPLIT, slots // tiles))
                                 if bf16 else EB_MAX_SPLIT)
        plan[name] = {"tiles": tiles, "splits": splits, "chunk": chunk}
    s0, s3 = plan["se"]["splits"], plan["d_htop"]["splits"]
    if bf16:
        scratch = (_pad4(-(-R * V // 2)) + _pad4(R) + _pad4(s0 * R * Ed)
                   + _pad4(-(-R // EB_DL_ROWS) * V) + s3 * R * H)
        launches = 6
    else:
        scratch = (_pad4(R * V) + _pad4(R) + _pad4(s0 * R * Ed)
                   + (s3 * R * H if s3 > 1 else 0))
        launches = 5 + (s3 > 1)
    return {**plan, "scratch_floats": scratch, "launches": launches,
            "ints": (s0, plan["se"]["chunk"], s3, plan["d_htop"]["chunk"],
                     scratch)}


_SM_COUNT = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def decode_sample_embed_bwd(h_top_tm, soft_tm, d_emb_tm, w_proj, disc_embed,
                            temperature: float):
    """The generator-side backward of mode ``sample_embed`` →
    ``(dWp [H, V], dbp [V], d_htop [T, B, H])`` from the top layer's
    ``h_top_tm [T, B, H]``, the saved ``soft_tm [T, B, V]``, the cotangent
    ``d_emb_tm [T, B, Ed]`` of ``emb``, ``w_proj [V, H]`` and ``disc_embed
    [Ed, V]`` (the JAX ``decode_sample_embed_bwd``), all float32 or all
    bfloat16 (the bfloat16 instantiation, the TPU kernel under ``dt =
    bfloat16``: dWp and dbp float32, d_htop bfloat16).  On CUDA tensors
    ``csrc/decode_embed_bwd.cu`` (one C call: tensor-core products over all
    T·B rows at once, 3xTF32 on float32 operands, bfloat16 ``mma.sync`` fed
    by ``ldmatrix`` from a cp.async ring on bfloat16 ones, sized by
    :func:`embed_bwd_plan`, each sum in a fixed order); on CPU tensors
    :func:`decode_sample_embed_bwd_plain`."""
    fn = "decode_sample_embed_bwd"
    if h_top_tm.ndim != 3 or d_emb_tm.ndim != 3 or disc_embed.ndim != 2:
        raise ValueError(f"{fn}: expected h_top [T, B, H], d_emb [T, B, Ed] "
                         "and disc_embed [Ed, V]")
    T, B, H = h_top_tm.shape
    Ed, V = disc_embed.shape
    device = h_top_tm.device
    dt = build.compute_dtype(fn, h_top_tm, True)
    for name, t, shape in (("h_top", h_top_tm, (T, B, H)),
                           ("soft", soft_tm, (T, B, V)),
                           ("d_emb", d_emb_tm, (T, B, Ed)),
                           ("w_proj", w_proj, (V, H)),
                           ("disc_embed", disc_embed, (Ed, V))):
        build.check_tensor(fn, name, t, shape, device, dt)
    if device.type == "cpu":
        return decode_sample_embed_bwd_plain(h_top_tm, soft_tm, d_emb_tm,
                                             w_proj, disc_embed,
                                             float(temperature))
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    bf16 = dt == torch.bfloat16
    lib = _bwd_library()
    plan = embed_bwd_plan(T * B, H, V, Ed, _sm_count(device), bf16)
    empty = _empty_on(device)
    scratch = empty(plan["scratch_floats"])
    dwp, dbp = empty(H, V), empty(V)
    d_htop = empty(T, B, H, dtype=dt)
    cplan = (ctypes.c_int * 5)(*plan["ints"])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_embed_bwd(
            h_top_tm.data_ptr(), soft_tm.data_ptr(), d_emb_tm.data_ptr(),
            w_proj.data_ptr(), disc_embed.data_ptr(), T * B, H, V, Ed,
            int(bf16), float(temperature), cplan, scratch.data_ptr(),
            dwp.data_ptr(), dbp.data_ptr(), d_htop.data_ptr(), stream)
    build.raise_on_error(lib, rc, fn)
    _count(decode_sample_embed_bwd, dtype=dt)
    return dwp, dbp, d_htop


def decode_sample_carry(features, lstm_layers: Sequence[dict], w_proj,
                        b_proj, embed, seq_len: int, init_state):
    """Mode ``serve`` resuming from ``init_state = (h0 [nl, B, H], c0
    [nl, B, H], x0 [B, E])`` (h0 and x0 in the weights' dtype, c0
    float32; ``x0`` is the first step's input, ``features`` is unread) →
    ``(ids [B, T], lps [B, T], (hT, cT, xT))``, ``xT = embed[ids[:,
    -1]]``: the state the next chunk resumes from."""
    device = features.device
    if device.type == "cuda":
        return _launch(features, lstm_layers, w_proj, b_proj, embed, seq_len,
                       init_state)
    if device.type != "cpu":
        raise ValueError(f"decode_sample: unsupported device {device}")
    B, E, H, _ = _validate(features, lstm_layers, w_proj, b_proj, embed,
                           seq_len, bf16=True)
    _validate_state("decode_sample", init_state, len(lstm_layers), B, E, H,
                    device, features.dtype)
    return decode_sample_plain(features, lstm_layers, w_proj, b_proj, embed,
                               seq_len, init_state)


def decode_sample(features, lstm_layers: Sequence[dict], w_proj, b_proj,
                  embed, seq_len: int, mode: str = "greedy",
                  init_state=None, seed: int = 0, temperature: float = 1.0,
                  uniforms=None, disc_embed=None):
    """Run the full T-step decode.

    Args mirror the JAX ``decode_sample``: ``features [B, E]`` (the t=0
    input), per-layer ``{w_ih [4H, In], w_hh [4H, H], b_ih, b_hh}``,
    ``w_proj [V, H]``, ``b_proj [V]``, ``embed [V, E]``, all float32;
    ``init_state`` (mode ``serve`` only, see :func:`decode_sample_carry`);
    every mode also takes them all in bfloat16 (the bfloat16
    instantiation), and raises TypeError for any other dtype;
    ``seed`` and ``uniforms`` are read by the Gumbel modes (``sample``,
    ``sample_resid``, ``sample_embed``), ``temperature`` by the soft ones
    (``sample_resid``, ``sample_embed``), ``disc_embed [Ed, V]`` by
    ``sample_embed``.  Returns ``ids [B, T]`` (``greedy``), ``(ids [B, T]
    int32, lps [B, T] f32)`` (``serve``; with ``init_state`` also ``(hT,
    cT, xT)``), ``(ids, logits [T, B, V])`` (``pretrain``), ``(ids, noise
    [T, B, V])`` (``sample``), ``(ids, soft, hs, cs, gates)``
    (``sample_resid``) or ``(ids, emb [T, B, Ed], soft, hs, cs, gates)``
    (``sample_embed``).
    """
    if init_state is not None:
        if mode != "serve":
            raise NotImplementedError(
                f"decode_sample mode {mode!r} with init_state: the carried "
                "state is ported for mode 'serve' only")
        return decode_sample_carry(features, lstm_layers, w_proj, b_proj,
                                   embed, seq_len, init_state)
    args = (features, lstm_layers, w_proj, b_proj, embed, seq_len)
    if mode == "sample_resid":
        return decode_sample_resid(*args, seed, temperature, uniforms)
    if mode == "sample":
        return decode_sample_noise(*args, seed, uniforms)
    if mode == "sample_embed":
        return decode_sample_embed(*args, disc_embed, seed, temperature,
                                   uniforms)
    if mode == "pretrain":
        return decode_sample_logits(*args)
    if mode not in ("serve", "greedy"):
        raise ValueError(f"decode_sample: unknown mode {mode!r}")
    if features.device.type == "cuda":
        ids, lps = _launch(*args)
    elif features.device.type == "cpu":
        _validate(*args, bf16=True)
        ids, lps = decode_sample_plain(*args)
    else:
        raise ValueError(f"decode_sample: unsupported device "
                         f"{features.device}")
    return ids if mode == "greedy" else (ids, lps)


# ------------------------------------------------------- quantized serve

def _q_check(name, t, shape, device, dtype=None):
    build.check_tensor("decode_sample_q_serve", name, t, shape, device, dtype)


def _q_scale(name, qt, n, device):
    """A QTensor's per-column scale ([1, n] in the JAX package's shapes)
    as the flat [n] the kernel reads."""
    scale = qt.scale.reshape(-1)
    _q_check(f"{name} scale", scale, (n,), device)
    return scale


def _q_validate(features, qdec, seq_len, bits, init_state):
    """Shapes, dtypes and devices of a quantized decoder against
    ``features`` and ``bits``; returns ``(B, E, H, V, nl, R_emb, flat
    scales)``.  The features' dtype (float32 or bfloat16) is the compute
    dtype; payloads are int8, scales and biases float32."""
    fn = "decode_sample_q_serve"
    if bits not in (4, 8):
        raise ValueError(f"{fn}: bits must be 4 or 8, got {bits}")
    if not qdec.get("lstm_q"):
        raise ValueError(f"{fn}: qdec needs a non-empty 'lstm_q'")
    _validate_batch(fn, features, seq_len)
    B, E = features.shape
    device = features.device
    dt = build.compute_dtype(fn, features, True)
    _q_check("features", features, (B, E), device, dt)
    nl = len(qdec["lstm_q"])
    H = qdec["lstm_q"][0]["w"].q.shape[1] // 4
    lin, emb = qdec["linear"], qdec["embed"]
    V = lin["b"].shape[0]

    def rows(n, name):
        if bits == 8:
            return n
        if n % 2:
            raise ValueError(f"{fn}: {name} has {n} rows to pack two per "
                             "byte: the row count must be even")
        return n // 2

    scales = []
    for l, lq in enumerate(qdec["lstm_q"]):
        k = (E if l == 0 else H) + H
        _q_check(f"layer {l} w", lq["w"].q, (rows(k, f"layer {l} w"), 4 * H),
                 device, torch.int8)
        scales.append(_q_scale(f"layer {l} w", lq["w"], 4 * H, device))
        _q_check(f"layer {l} b", lq["b"], (4 * H,), device)
    _q_check("linear w", lin["w"].q, (rows(H, "linear w"), V), device,
             torch.int8)
    scales.append(_q_scale("linear w", lin["w"], V, device))
    _q_check("linear b", lin["b"], (V,), device)
    r_emb = V if bits == 8 else -(-V // 2)
    _q_check("embed", emb.q, (r_emb, E), device, torch.int8)
    scales.append(_q_scale("embed", emb, E, device))
    _validate_state(fn, init_state, nl, B, E, H, device, dt)
    return B, E, H, V, nl, r_emb, scales


def dequantized_decoder(qdec: dict, bits: int = 8, dtype=torch.float32):
    """A quantized decoder → the dense decode's arguments ``(lstm_layers,
    w_proj [V, H], b_proj [V], embed [V, E])``, each weight
    ``float(q) * scale`` rounded to ``dtype`` (contiguous; the TPU
    kernel's ``_dq(...).astype(dt)``): ``w_ih`` / ``w_hh`` the transposed
    input / hidden rows of the fused ``[in+H, 4H]`` matrix, ``b_ih`` its
    bias and ``b_hh`` zero (float32)."""
    def deq(qt):
        q = unpack_int4_rows(qt.q) if bits == 4 else qt.q
        return (q.to(torch.float32) * qt.scale).to(dtype)

    V = qdec["linear"]["b"].shape[0]
    layers = []
    for lq in qdec["lstm_q"]:
        w = deq(lq["w"])
        in_dim = w.shape[0] - w.shape[1] // 4
        layers.append({"w_ih": w[:in_dim].T.contiguous(),
                       "w_hh": w[in_dim:].T.contiguous(),
                       "b_ih": lq["b"], "b_hh": torch.zeros_like(lq["b"])})
    return (layers, deq(qdec["linear"]["w"]).T.contiguous(),
            qdec["linear"]["b"], deq(qdec["embed"])[:V].contiguous())


def decode_sample_q_serve_plain(features, qdec: dict, seq_len: int,
                                init_state=None, bits: int = 8):
    """Plain version of :func:`decode_sample_q_serve`: dequantize every
    weight once into the features' dtype (as the TPU kernel does into
    VMEM), then the dense plain decode."""
    layers, w_proj, b_proj, embed = dequantized_decoder(qdec, bits,
                                                        features.dtype)
    return decode_sample_plain(features, layers, w_proj, b_proj, embed,
                               seq_len, init_state)


def decode_sample_q_serve(features, qdec: dict, seq_len: int,
                          init_state=None, bits: int = 8):
    """Mode ``serve`` on a quantized decoder (``ops/quantize.py``
    ``quantize_lstm_decoder`` layout: fused ``lstm_q`` ``[in+H, 4H]``
    QTensors, pre-transposed ``linear.w`` ``[H, V]``, ``embed [V, E]``;
    ``bits`` 4: every payload row-packed, :func:`pack_int4_rows`) →
    ``(ids [B, T], lps [B, T])``, with ``init_state`` also ``(hT, cT,
    xT)`` — the return contract of :func:`decode_sample` mode ``serve``.
    The features' dtype is the compute dtype (the TPU kernel's
    ``x_ref.dtype``): float32, or bfloat16, where every dequantized
    weight, h and x are rounded to bfloat16 and c and the log-probabilities
    stay float32 (``init_state``: h0 and x0 in it, c0 float32).
    CUDA tensors launch the persistent kernel of ``csrc/decode_serve.cu``
    on the quantized weights (one cooperative launch; the weights are
    dequantized in the kernel, bit-equal to :func:`decode_sample` on
    :func:`dequantized_decoder`'s weights); CPU tensors run
    :func:`decode_sample_q_serve_plain`."""
    B, E, H, V, nl, r_emb, scales = _q_validate(features, qdec, seq_len,
                                                bits, init_state)
    device = features.device
    if device.type == "cpu":
        return decode_sample_q_serve_plain(features, qdec, seq_len,
                                           init_state, bits)
    if device.type != "cuda":
        raise ValueError(f"decode_sample_q_serve: unsupported device "
                         f"{device}")
    carry = init_state is not None
    h0, c0, x0 = init_state if carry else (None, None, None)
    lib = _library()
    ntile = -(-V // lib.gic_proj_tile())
    plan, cplan, barrier = _plan_args(lib, device, B, E, H, V, nl,
                                      quantized=True)
    ptrs = []
    for lq, scale in zip(qdec["lstm_q"], scales):
        ptrs += [lq["w"].q.data_ptr(), scale.data_ptr(), lq["b"].data_ptr()]
    layer_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lin, emb = qdec["linear"], qdec["embed"]
    bufs = _state_buffers(_empty_on(device), nl, B, E, H, seq_len, ntile,
                          carry, features.dtype)
    p = {k: v.data_ptr() for k, v in bufs.items()}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_decode_qserve(
            features.data_ptr(), layer_ptrs, lin["w"].q.data_ptr(),
            scales[-2].data_ptr(), lin["b"].data_ptr(), emb.q.data_ptr(),
            scales[-1].data_ptr(), bits, int(features.dtype == torch.bfloat16),
            B, E, H, V, r_emb, nl, seq_len,
            _ptr(h0), _ptr(c0), _ptr(x0), p["x"], p["h"], p["c"], p["pmax"],
            p["pidx"], p["psum"], p["ids"], p["lps"], p.get("hT"),
            p.get("cT"), p.get("xT"), cplan, barrier.data_ptr(), stream)
    build.raise_on_error(lib, rc, "decode_qserve")
    _count(decode_sample_q_serve, plan, features.dtype)
    return _outputs(bufs, carry)


# persistent decode launches by where the blocks' LSTM weights came from:
# shared memory for the whole call ("resident") or global memory each step
# ("streamed"); and the plan of the last launch
branches = {"resident": 0, "streamed": 0}
last_plan = None

for _fn in (decode_sample, decode_sample_carry, decode_sample_logits,
            decode_sample_noise, decode_sample_resid, decode_sample_embed,
            decode_sample_embed_bwd, decode_sample_q_serve):
    _fn.launches = _fn.bf16_launches = 0
