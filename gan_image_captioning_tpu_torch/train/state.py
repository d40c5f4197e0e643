"""Training state and the clipped Adam update
(``gan_image_captioning_tpu/train/state.py``).

:class:`TrainState` holds everything a step changes: the generator and
discriminator modules, three Adam states (pretrain, adversarial generator,
discriminator — the reference's three optimizers), the step counters, the
Gumbel temperature and a ``torch.Generator`` for the noise the steps draw.

:func:`clip_adam_update` follows the optax numerics of the JAX package's
``clip_by_global_norm`` → ``adam`` chain (``train/state.py:161-186``):
``scale = clip / max(gnorm, clip)`` (not ``clip_grad_norm_``'s
``clip / (gnorm + 1e-6)``), betas 0.9 / 0.999, eps 1e-8, bias-corrected,
constant learning rate.  Parameters and moments are updated in place under
``no_grad``, where the JAX package builds new trees.  Only parameters that
require gradients have moments: a frozen image backbone
(``--trainable-backbone 0``) stays out of the optimizer, where the JAX
package's Adam sees its zero gradients (under ``stop_gradient``) and makes
exactly zero updates, and adds nothing to the global norm.  Learning-rate
schedules, EMA, bfloat16 first moments, gradient accumulation and
``--dtype bfloat16`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models import api
from gan_image_captioning_tpu_torch.models.discriminator import Discriminator
from gan_image_captioning_tpu_torch.models.generator import Generator

B1, B2, EPS = 0.9, 0.999, 1e-8  # torch Adam / optax.adam defaults


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


def adam_init(module: nn.Module) -> AdamState:
    zeros = {k: torch.zeros_like(p)
             for k, p in trainable_parameters(module).items()}
    return AdamState(0, zeros, {k: torch.zeros_like(v)
                                for k, v in zeros.items()})


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


@torch.no_grad()
def clip_adam_update(module: nn.Module, grads: Dict[str, torch.Tensor],
                     state: AdamState, lr: float, clip_norm: float,
                     gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One clip → Adam → apply update of ``module``'s parameters that have
    moments in ``state``, in place.  Returns the pre-clip global norm."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
    state.count += 1
    bc1, bc2 = 1.0 - B1 ** state.count, 1.0 - B2 ** state.count
    params = dict(module.named_parameters())
    for name in state.mu:
        p = params[name]
        g = grads[name] * scale
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(B1).add_(g, alpha=1.0 - B1)
        nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + EPS))
    return gnorm


def require_ported_training(config: Config) -> None:
    """Raise for a training option that is not ported yet."""
    if config.dtype != "float32":
        raise NotImplementedError(f"--dtype {config.dtype}: only float32 "
                                  "training is ported yet")
    for name, default in (("lr_schedule", "constant"), ("ema_decay", 0.0),
                          ("grad_accum", 1)):
        if getattr(config, name) != default:
            raise NotImplementedError(f"{name} = {getattr(config, name)!r}:"
                                      " not ported yet")
    api.require_ported(config)


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


def freeze_backbone(gen: Generator, config: Config) -> Generator:
    """A conditional generator's backbone requires gradients only under
    ``--trainable-backbone 1``."""
    if gen.encoder is not None:
        gen.encoder.resnet.requires_grad_(bool(config.trainable_backbone))
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
    return TrainState(gen=gen, disc=disc, pretrain_opt=adam_init(gen),
                      gen_opt=adam_init(gen), disc_opt=adam_init(disc),
                      generator=torch.Generator().manual_seed(seed + 1))


def with_generator(state: TrainState, gen: Generator,
                   config: Config) -> TrainState:
    """``state`` with ``gen`` in place of its generator and fresh
    generator optimizers (``--init-gen-ckpt``)."""
    freeze_backbone(gen, config)
    return dataclasses.replace(state, gen=gen, pretrain_opt=adam_init(gen),
                               gen_opt=adam_init(gen))
