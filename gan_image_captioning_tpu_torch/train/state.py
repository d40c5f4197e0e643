"""Training state and the clipped Adam update
(``gan_image_captioning_tpu/train/state.py``).

:class:`TrainState` holds everything a step changes: the generator and
discriminator modules, three Adam states (pretrain, adversarial generator,
discriminator — the reference's three optimizers), the step counters, the
Gumbel temperature, a ``torch.Generator`` for the noise the steps draw and,
under ``--ema-decay``, the generator's exponential moving average.

:func:`clip_adam_update` follows the optax numerics of the JAX package's
``clip_by_global_norm`` → ``adam`` chain (``train/state.py:161-186``):
``scale = clip / max(gnorm, clip)`` (not ``clip_grad_norm_``'s
``clip / (gnorm + 1e-6)``), betas 0.9 / 0.999, eps 1e-8, bias-corrected,
the learning rate of :func:`lr_at` at the update count before the
increment (optax's ``scale_by_schedule``).  Parameters and moments are
updated in place under ``no_grad``, where the JAX package builds new
trees.  Only parameters that require gradients have moments: a frozen
image backbone (``--trainable-backbone 0``) stays out of the optimizer,
where the JAX package's Adam sees its zero gradients (under
``stop_gradient``) and makes exactly zero updates, and adds nothing to the
global norm.  ``Config.bf16_mu`` (the JAX package's
``GIC_BF16_MU=1``: optax's ``mu_dtype``) stores every first moment in
bfloat16; the update is computed in float32, ``b1' · mu + (1 − b1) · g``
with the stored moment widened and ``b1'`` = :data:`B1_BF16`, as the
jitted optax update computes it (``b1 · mu`` of a bfloat16 ``mu`` takes
b1 in bfloat16, and XLA keeps the exact product in float32), the moment
rounded back for storage, the second moment float32.  A moment's dtype is the
tensor's own, so a state saved or converted with bfloat16 moments keeps
them.

The EMA (:func:`ema_init`, :func:`ema_update`, the JAX ``_ema_update``)
shadows every floating-point entry of the generator's ``state_dict``: its
parameters, a frozen backbone's included, and a conditional generator's
BatchNorm running statistics, as the JAX ``ema_gen_params`` shadows the
whole ``gen_params`` tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import (Config,
                                                   require_ported_dtype)
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models.discriminator import Discriminator
from gan_image_captioning_tpu_torch.models.generator import Generator

B1, B2, EPS = 0.9, 0.999, 1e-8  # torch Adam / optax.adam defaults
# b1 as optax multiplies a bfloat16 first moment by it: JAX's weak typing
# rounds the Python float to the moment's dtype, 0.8984375
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and per-parameter first
    and second moments, keyed by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def trainable_parameters(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s parameters that require gradients, by name."""
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def adam_init(module: nn.Module, config: Optional[Config] = None
              ) -> AdamState:
    """Zero moments of ``module``'s trainable parameters: float32, the
    first moment bfloat16 under ``config.bf16_mu``."""
    nu = {k: torch.zeros_like(p)
          for k, p in trainable_parameters(module).items()}
    mu_dtype = (torch.bfloat16 if config is not None and config.bf16_mu
                else None)
    return AdamState(0, {k: torch.zeros_like(v, dtype=mu_dtype)
                         for k, v in nu.items()}, nu)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def _check_schedule(config: Config) -> None:
    """The JAX ``lr_schedule_fn``'s refusals (``train/state.py:58-60,
    69-71``), with its texts."""
    if config.lr_schedule != "constant" and int(config.lr_decay_steps) <= 0:
        raise ValueError("--lr-schedule %r needs --lr-decay-steps > 0"
                         % config.lr_schedule)
    if (config.lr_schedule == "exponential"
            and not 0.0 < config.lr_min_ratio < 1.0):
        raise ValueError("--lr-schedule exponential needs "
                         "0 < --lr-min-ratio < 1 (the per-horizon rate)")
    if config.lr_schedule not in ("constant", "cosine", "linear",
                                  "exponential"):
        raise ValueError(f"--lr-schedule {config.lr_schedule!r}: expected "
                         "constant, cosine, linear or exponential")


def _main_schedule(base_lr: float, config: Config, count: np.float32):
    """The decay shape at ``count`` steps past the warmup, in float32 as
    optax computes it under ``jit`` (an int32 count, weak-typed Python
    constants)."""
    f32 = np.float32
    decay = int(config.lr_decay_steps)
    ratio = config.lr_min_ratio
    if config.lr_schedule == "cosine":      # optax.cosine_decay_schedule
        c = np.minimum(count, f32(decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return f32(base_lr) * (f32(1 - ratio) * cos + f32(ratio))
    if config.lr_schedule == "linear":      # optax.linear_schedule
        end = base_lr * ratio
        c = np.clip(count, f32(0), f32(decay))
        frac = f32(1) - c / f32(decay)
        return f32(base_lr - end) * frac + f32(end)
    if config.lr_schedule == "exponential":  # optax.exponential_decay
        if count <= 0:
            return f32(base_lr)
        return f32(base_lr) * np.power(f32(ratio), count / f32(decay))
    return f32(base_lr)


def lr_at(base_lr: float, config: Config, count: int) -> float:
    """The learning rate of an update whose optimizer count is ``count``
    before it (optax evaluates the schedule there, so with warmup the
    first update has lr 0): the JAX ``lr_schedule_fn`` — a linear warmup 0
    → ``base_lr`` over ``--lr-warmup-steps`` joined in front
    (``optax.join_schedules``) of the ``--lr-schedule`` shape over
    ``--lr-decay-steps``: cosine down to ``base · min_ratio``, linear to
    it, or exponential at the rate ``min_ratio`` per horizon.  The
    constant default without warmup is ``base_lr`` itself."""
    if config.lr_schedule == "constant" and config.lr_warmup_steps <= 0:
        return base_lr
    _check_schedule(config)
    f32 = np.float32
    warmup = max(int(config.lr_warmup_steps), 0)
    step = f32(count)
    if warmup > 0 and count < warmup:        # linear_schedule(0, base, w)
        frac = f32(1) - np.clip(step, f32(0), f32(warmup)) / f32(warmup)
        return float(f32(0.0 - base_lr) * frac + f32(base_lr))
    return float(_main_schedule(base_lr, config, f32(count - warmup)))


@torch.no_grad()
def clip_adam_update(module: nn.Module, grads: Dict[str, torch.Tensor],
                     state: AdamState, lr: float, clip_norm: float,
                     config: Config,
                     gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One clip → Adam → apply update of ``module``'s parameters that have
    moments in ``state``, in place, at ``lr_at(lr, config, count)``.
    Returns the pre-clip global norm."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
    lr = lr_at(lr, config, state.count)
    state.count += 1
    bc1, bc2 = 1.0 - B1 ** state.count, 1.0 - B2 ** state.count
    params = dict(module.named_parameters())
    for name in state.mu:
        p = params[name]
        g = grads[name] * scale
        mu, nu = state.mu[name], state.nu[name]
        if mu.dtype == torch.float32:
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            m = mu
        else:   # a bfloat16 first moment: the update in float32
            m = mu.to(torch.float32).mul_(B1_BF16).add_(g, alpha=1.0 - B1)
            mu.copy_(m)
        nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        p.sub_(lr * (m / bc1) / (torch.sqrt(nu / bc2) + EPS))
    return gnorm


def require_ported_training(config: Config) -> None:
    """Raise for a dtype the port does not run (``require_ported_dtype``),
    a model it does not have (``api.require_ported``) and an invalid
    learning-rate schedule."""
    require_ported_dtype(config)
    _check_schedule(config)
    api.require_ported(config)


def ema_init(gen: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every floating-point ``state_dict`` entry of ``gen``."""
    return {k: v.detach().clone() for k, v in gen.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def ema_update(config: Config, ema: Optional[Dict[str, torch.Tensor]],
               gen: nn.Module) -> None:
    """``e ← e·d + p·(1−d)`` for every EMA entry, in place, from ``gen``'s
    current values (``--ema-decay`` d; nothing when off)."""
    if ema is None or config.ema_decay <= 0.0:
        return
    d = config.ema_decay
    current = gen.state_dict()
    es = list(ema.values())
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, torch._foreach_mul(
        [current[k] for k in ema], 1.0 - d))


@dataclasses.dataclass
class TrainState:
    """Everything a training step changes (the JAX ``TrainState``).  The
    models are those of ``config.gen_arch`` / ``config.disc_arch``: an LSTM
    ``Generator`` or a ``TransformerGenerator``, a CNN ``Discriminator`` or
    a ``TransformerDiscriminator``."""

    gen: Generator
    disc: Discriminator
    pretrain_opt: AdamState
    gen_opt: AdamState
    disc_opt: AdamState
    generator: torch.Generator       # host-side: seeds of the step noise
    pretrain_steps: int = 0
    gen_steps: int = 0
    disc_steps: int = 0
    temperature: float = 1.0
    # the generator's EMA (``--ema-decay`` > 0), by state_dict name
    ema_gen: Optional[Dict[str, torch.Tensor]] = None


def freeze_backbone(gen: Generator, config: Config) -> Generator:
    """A conditional generator's backbone (ResNet-18 or ViT) requires
    gradients only under ``--trainable-backbone 1``: a frozen one stays out
    of the optimizer."""
    if gen.encoder is not None:
        gen.encoder.backbone.requires_grad_(bool(config.trainable_backbone))
    return gen


def create_train_state(config: Config, seed: int, device="cpu",
                       gen: Optional[Generator] = None,
                       disc: Optional[Discriminator] = None,
                       sweep: bool = True) -> TrainState:
    """Seeded models (unless given) and fresh optimizer and counter state.
    ``sweep`` applies the reference's init sweep to new models."""
    require_ported_training(config)
    init = torch.Generator().manual_seed(seed)
    if gen is None:
        gen = api.init_generator(init, config, device, sweep)
    if disc is None:
        disc = api.init_discriminator(init, config, device, sweep)
    freeze_backbone(gen, config)
    return TrainState(gen=gen, disc=disc, pretrain_opt=adam_init(gen, config),
                      gen_opt=adam_init(gen, config),
                      disc_opt=adam_init(disc, config),
                      generator=torch.Generator().manual_seed(seed + 1),
                      ema_gen=ema_init(gen) if config.ema_decay > 0 else None)


def with_generator(state: TrainState, gen: Generator,
                   config: Config) -> TrainState:
    """``state`` with ``gen`` in place of its generator and fresh
    generator optimizers (``--init-gen-ckpt``).  The EMA stays the one
    ``create_train_state`` made, as the JAX instructor keeps its
    ``ema_gen_params`` when it swaps the generator's params in."""
    freeze_backbone(gen, config)
    return dataclasses.replace(state, gen=gen,
                               pretrain_opt=adam_init(gen, config),
                               gen_opt=adam_init(gen, config))
