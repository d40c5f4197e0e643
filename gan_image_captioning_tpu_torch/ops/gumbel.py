"""Gumbel-softmax relaxation (``gan_image_captioning_tpu/ops/gumbel.py``).

The reference adds Gumbel(0,1) noise to the decoder logits and softmaxes
the result *multiplied* by the temperature:

    pred = softmax(temperature * (logits + g)),   g = -log(-log(u + eps) + eps)

Every function takes the uniforms ``u`` when the caller has them (the
tests feed the JAX package's draws) and otherwise draws them from a
``torch.Generator`` on the logits' device.
"""

from __future__ import annotations

import torch

from gan_image_captioning_tpu_torch.config import decode_route
from gan_image_captioning_tpu_torch.kernels.gumbel_sample import (
    fused_gumbel_sample)

EPS = 1e-10  # the reference's add_gumbel eps


def _uniforms(shape, generator, device, dtype):
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def gumbel_noise(shape, generator=None, device="cpu", dtype=torch.float32,
                 eps: float = EPS, u=None):
    """Gumbel(0,1) noise by the reference's double-log formula, of the
    uniforms ``u`` or of fresh ones drawn from ``generator``."""
    if u is None:
        u = _uniforms(shape, generator, device, dtype)
    return -torch.log(-torch.log(u + eps) + eps)


def use_fused_sampler(config) -> bool:
    """``--use-pallas`` (the JAX ``Config.resolve_use_pallas`` and
    ``set_use_pallas``, per config here, not process-wide): ``auto`` and
    ``on`` route the callers of :func:`gumbel_softmax` through the fused
    sampler (its kernel on CUDA tensors, its plain version on CPU ones),
    ``off`` through the plain draw, also on the card.  The ``plain`` decode
    route (``config.decode_route``) takes the plain draw whatever the
    flag says."""
    if config.use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"--use-pallas {config.use_pallas!r}: expected "
                         "auto, on or off")
    return config.use_pallas != "off" and decode_route(config) != "plain"


def gumbel_softmax(logits, temperature, generator=None, eps: float = EPS,
                   u=None, kernel: bool = False, seed: int = 0,
                   step: int = 0):
    """``(soft [..., V], ids [...])``: ``softmax(temperature * (logits +
    g))`` and its argmax (first index on ties), a categorical draw from
    ``softmax(logits)``.

    ``kernel`` (:func:`use_fused_sampler`, the JAX package's
    ``set_use_pallas``): 2-D logits go through the fused sampler
    (``kernels/gumbel_sample.py``): on CUDA tensors its kernel, with the
    fed uniforms ``u`` or Philox keyed by ``(seed, step)``; on CPU ones its
    plain version.  Its ids are the argmax of ``(logits + g) *
    temperature``, as the TPU kernel's; this route's, of the soft row.
    Under ``--dtype bfloat16`` this route computes in the logits' dtype,
    fed uniforms rounded to it, as the JAX package's ``add_gumbel`` draws
    bfloat16 uniforms and rounds at each operation."""
    if kernel and logits.ndim == 2:
        return fused_gumbel_sample(logits, seed, temperature, step, u)
    # in the logits' dtype, as the JAX add_gumbel draws its uniforms
    g = gumbel_noise(logits.shape, generator, logits.device, logits.dtype,
                     eps, None if u is None else u.to(logits.dtype))
    soft = torch.softmax((logits + g) * temperature, dim=-1)
    return soft, torch.argmax(soft, dim=-1)
