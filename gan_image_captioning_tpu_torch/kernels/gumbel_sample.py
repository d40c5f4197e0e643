"""Fused Gumbel-softmax sampler: the CUDA kernel and its plain version.

Counterpart of ``gan_image_captioning_tpu/kernels/gumbel_sample.py``
(``fused_gumbel_sample``): for logits ``[B, V]``,

    g = -log(-log(u + 1e-10) + 1e-10),   x = (logits + g) * temperature
    soft = softmax(x),                   ids = argmax(x)  (first index)

in one pass over each row.  The noise is Philox keyed by ``(seed, step)``
in the kernel (the stream of the ``sample_resid`` decode at step
``step``), or the fed uniforms ``u [B, V]``.

* On CUDA tensors :func:`gumbel_sample` launches the kernel
  (``csrc/gumbel_sample.cu``, built at first use) or raises.
* On CPU tensors it runs :func:`gumbel_sample_plain` on the fed uniforms,
  or on ``torch.rand`` from a generator seeded with ``(seed, step)``
  (another stream than Philox, the same distribution).

:func:`fused_gumbel_sample` is the differentiable form: its backward is the
softmax VJP scaled by the temperature, in plain PyTorch, as the JAX
package's is jnp.  ``gumbel_sample.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
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
        lib.gic_gumbel_sample.argtypes = [vp, i, i, ctypes.c_float,
                                          ctypes.c_uint64, i] + [vp] * 5
        lib.gic_gumbel_sample.restype = i
        lib._gic_typed = True
    return lib


def gumbel_sample(logits, temperature, seed: int = 0, step: int = 0,
                  uniforms=None, uniforms_out=None):
    """``(soft [B, V], ids [B] int32)`` without gradient.  ``uniforms``
    ``[B, V]`` feed the noise; a float32 ``uniforms_out [B, V]`` receives
    the uniforms used."""
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
    if B < 1 or V < 1:
        raise ValueError(f"gumbel_sample: empty logits {tuple(logits.shape)}")
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
            soft.data_ptr(), ids.data_ptr(), stream)
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
