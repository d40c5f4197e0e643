"""Fused Gumbel-softmax sampler: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/gumbel_sample.py``
(``fused_gumbel_sample``): for logits ``[B, V]``,

    g = -log(-log(u + 1e-10) + 1e-10),   x = (logits + g) * temperature
    soft = softmax(x),                   ids = argmax(x)  (first index)

in one pass over each row.  The noise is Philox keyed by ``(seed, step)``
in the kernel (the stream of the ``sample_resid`` decode at step
``step``), or the fed uniforms ``u [B, V]``.

* On CUDA tensors :func:`gumbel_sample` launches the kernel
  (``csrc/gumbel_sample.cu``, built at first use) or raises: a row split
  over a thread-block cluster of up to 8 CTAs (a cluster launch, sm_90a),
  or, for small V, a warp per row, by :func:`gumbel_plan`.
* On CPU tensors it runs :func:`gumbel_sample_plain` on the fed uniforms,
  or on ``torch.rand`` from a generator seeded with ``(seed, step)``
  (another stream than Philox, the same distribution).

:func:`fused_gumbel_sample` is the differentiable form: its backward is the
softmax VJP scaled by the temperature, in plain PyTorch, as the JAX
package's is jnp.  ``gumbel_sample.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from gan_image_captioning_tpu_torch.kernels import build

EPS = 1e-10  # the reference's add_gumbel eps

_count_lock = threading.Lock()


def step_uniforms(seed: int, step: int, shape, device):
    """The plain version's stand-in for the Philox draw of ``(seed,
    step)``: ``torch.rand`` from a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + int(step)) % (2 ** 63))
    return torch.rand(shape, generator=gen, device=device)


def gumbel_sample_plain(logits, temperature, uniforms):
    """Plain PyTorch version on the uniforms ``[B, V]`` → ``(soft [B, V],
    ids [B] int32)``, ids the first argmax of x."""
    g = -torch.log(-torch.log(uniforms + EPS) + EPS)
    x = (logits + g) * temperature
    return torch.softmax(x, dim=-1), torch.argmax(x, dim=-1).to(torch.int32)


def _library() -> ctypes.CDLL:
    lib = build.load("gumbel_sample")
    if not getattr(lib, "_gic_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gic_gumbel_sample.argtypes = ([vp, i, i, ctypes.c_float,
                                           ctypes.c_uint64, i] + [vp] * 4
                                          + [i] * 6 + [vp])
        lib.gic_gumbel_sample.restype = i
        lib._gic_typed = True
    return lib


# csrc/gumbel_sample.cu's geometry: a cluster of at most G_MAX_CLUSTER CTAs
# a row, G_NT threads a CTA (G_NT_MAX where a thread would need more than
# G_VPT_MAX groups of 4 columns); rows of at most G_ROW_MAX_V columns take a
# warp each, G_ROWS a CTA.  B·S should reach G_TARGET_CTAS CTAs: about one
# on each of the H100's 132 SMs (at [64, 11008] two CTAs a row beat four
# and eight on the card, PERF.md).
G_MAX_CLUSTER, G_NT, G_NT_MAX, G_VPT_MAX = 8, 256, 512, 8
G_ROWS = 8
G_ROW_MAX_V = 32 * 4 * G_VPT_MAX
G_TARGET_CTAS = 128
G_V_MAX = G_MAX_CLUSTER * G_NT_MAX * G_VPT_MAX * 4


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@functools.lru_cache(maxsize=64)
def gumbel_plan(B: int, V: int) -> dict:
    """The launch of :func:`gumbel_sample` for logits ``[B, V]``, from the
    shape alone: ``cluster`` (S) CTAs a row, the fewest (a power of two, at
    most ``G_MAX_CLUSTER``) that give ``G_TARGET_CTAS`` CTAs and leave no
    thread more than ``G_VPT_MAX`` groups of 4 columns; S = 1 and
    ``V <= G_ROW_MAX_V`` take a warp per row, ``rows`` a CTA, and no
    cluster.  ``chunk``: the columns of a CTA's slice of a row (CTA rank r
    takes ``[r·chunk, (r+1)·chunk)``); ``threads`` a CTA; ``vecs``: groups
    of 4 columns a thread (a power of two; the last may lie past the
    slice); ``ctas`` in all.  The C side recomputes the plan from
    ``(B, V, cluster)`` and refuses a launch that differs.  Raises
    ValueError where no launch fits: an empty shape, or a row of more than
    ``G_V_MAX`` columns (each thread holds its columns in registers)."""
    if B < 1 or V < 1:
        raise ValueError(f"gumbel_plan: empty logits [{B}, {V}]")
    if V > G_V_MAX:
        raise ValueError(f"gumbel_plan: V = {V} passes {G_V_MAX} columns "
                         f"({G_MAX_CLUSTER} CTAs of {G_NT_MAX} threads of "
                         f"{G_VPT_MAX} groups of 4)")
    groups = -(-V // 4)
    cluster = 1
    if V > G_ROW_MAX_V:
        while cluster < G_MAX_CLUSTER and (
                B * cluster < G_TARGET_CTAS
                or -(-groups // cluster) > G_NT_MAX * G_VPT_MAX):
            cluster *= 2
    if cluster == 1 and V <= G_ROW_MAX_V:
        return {"mode": "rows", "cluster": 1, "threads": 32 * G_ROWS,
                "vecs": _pow2_at_least(-(-groups // 32)), "rows": G_ROWS,
                "chunk": V, "ctas": -(-B // G_ROWS), "vec4": V % 4 == 0}
    per_cta = -(-groups // cluster)
    threads = min(G_NT, 32 * -(-per_cta // 32))
    if -(-per_cta // threads) > G_VPT_MAX:
        threads = G_NT_MAX
    return {"mode": "cluster", "cluster": cluster, "threads": threads,
            "vecs": _pow2_at_least(-(-per_cta // threads)), "rows": 1,
            "chunk": 4 * per_cta, "ctas": B * cluster, "vec4": V % 4 == 0}


def gumbel_sample(logits, temperature, seed: int = 0, step: int = 0,
                  uniforms=None, uniforms_out=None):
    """``(soft [B, V], ids [B] int32)`` without gradient.  ``uniforms``
    ``[B, V]`` feed the noise; a float32 ``uniforms_out [B, V]`` receives
    the uniforms used.  On a CUDA tensor, one launch by
    :func:`gumbel_plan`, counted; rows of more than ``G_V_MAX`` (131 072)
    columns raise ValueError there."""
    if logits.ndim != 2:
        raise ValueError(f"gumbel_sample: logits must be [B, V], got "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    device = logits.device
    for name, u in (("uniforms", uniforms), ("uniforms_out", uniforms_out)):
        if u is not None:
            build.check_tensor("gumbel_sample", name, u, (B, V), device)
    if device.type == "cpu":
        if uniforms is None:
            uniforms = step_uniforms(seed, step, (B, V), device)
        if uniforms_out is not None:
            uniforms_out.copy_(uniforms)
        return gumbel_sample_plain(logits, float(temperature), uniforms)
    if device.type != "cuda":
        raise ValueError(f"gumbel_sample: unsupported device {device}")
    build.check_tensor("gumbel_sample", "logits", logits, (B, V), device)
    plan = gumbel_plan(B, V)
    soft = torch.empty_like(logits)
    ids = torch.empty((B,), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gic_gumbel_sample(
            logits.data_ptr(), B, V, float(temperature),
            int(seed) & (2 ** 64 - 1), int(step),
            None if uniforms is None else uniforms.data_ptr(),
            None if uniforms_out is None else uniforms_out.data_ptr(),
            soft.data_ptr(), ids.data_ptr(), plan["cluster"],
            plan["threads"], plan["vecs"], plan["rows"], plan["chunk"],
            plan["ctas"], stream)
    build.raise_on_error(lib, rc, "gumbel_sample")
    with _count_lock:
        gumbel_sample.launches += 1
    return soft, ids


class _FusedGumbel(torch.autograd.Function):
    """Forward: :func:`gumbel_sample`; backward: ``temp · soft ∘ (d −
    Σ d∘soft)`` (the noise is constant in the logits)."""

    @staticmethod
    def forward(ctx, logits, temperature, seed, step, uniforms):
        soft, ids = gumbel_sample(logits, temperature, seed, step, uniforms)
        ctx.save_for_backward(soft)
        ctx.temperature = float(temperature)
        ctx.mark_non_differentiable(ids)
        return soft, ids

    @staticmethod
    def backward(ctx, d_soft, _d_ids):
        soft, = ctx.saved_tensors
        inner = (d_soft * soft).sum(dim=-1, keepdim=True)
        return (ctx.temperature * soft * (d_soft - inner), None, None, None,
                None)


def fused_gumbel_sample(logits, seed: int, temperature, step: int = 0,
                        uniforms=None):
    """``(soft [B, V], ids [B])``, differentiable in ``logits``: the kernel
    on CUDA tensors, the plain version on CPU ones."""
    return _FusedGumbel.apply(logits.contiguous(), float(temperature),
                              int(seed), int(step), uniforms)


gumbel_sample.launches = 0
