"""Checkpoints in the reference ``state_dict`` layout
(``gan_image_captioning_tpu/train/checkpoint.py:load_generator_checkpoint``).

A checkpoint is a ``torch.save``-d dict with the reference's keys: either
the generator ``state_dict`` itself (``pretrained_model.ckpt`` style) or
``{"generator": …, "discriminator": …, "conditional": bool}``
(``adv_model.ckpt`` style).  Generator keys are ``decoder.embed.weight``,
``decoder.lstm.weight_ih_l{k}``, ``decoder.linear.weight`` … and, for a
conditional generator, ``encoder.resnet.{0,1,4,5,6,7}.*`` (the reference
encoder's ``nn.Sequential`` numbers for torchvision's ``conv1``, ``bn1``,
``layer1``-``layer4``), ``encoder.linear.*`` and ``encoder.bn.*`` with the
BatchNorm running statistics (``models/torch_export.py:43-102``).
``src/export_torch.py`` writes both forms from a JAX checkpoint.  A
checkpoint is conditional when its ``conditional`` flag says so, or, in
the plain form, when it holds encoder keys; loading it under the other
``--conditional-gan`` raises.

A transformer generator (``--gen-arch transformer``) is saved under its
JAX tree paths (``decoder.embed``, ``decoder.blocks.{i}.attn.wq.w`` …); the
adversarial form carries ``"gen_arch": "transformer"``, the plain form is
recognised by its ``decoder.pos`` key, and loading a checkpoint under the
other ``--gen-arch`` raises.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.generator import Generator
from gan_image_captioning_tpu_torch.models.transformer import (
    TransformerGenerator)

# torchvision resnet18 module names → the reference Encoder's nn.Sequential
# indices (resnet18 children minus avgpool/fc: conv1, bn1, relu, maxpool,
# layer1..layer4)
_TO_SEQUENTIAL = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                  "layer3": "6", "layer4": "7"}
_FROM_SEQUENTIAL = {v: k for k, v in _TO_SEQUENTIAL.items()}
_RESNET = "encoder.resnet."


def _rename_backbone(key: str, table: Dict[str, str]) -> str:
    if not key.startswith(_RESNET):
        return key
    head, _, tail = key[len(_RESNET):].partition(".")
    return _RESNET + table[head] + "." + tail


def generator_state_dict(generator: Generator) -> Dict[str, torch.Tensor]:
    """``generator``'s state on the CPU under the reference's keys."""
    return {_rename_backbone(k, _TO_SEQUENTIAL): v.detach().cpu()
            for k, v in generator.state_dict().items()}


def save_generator_checkpoint(path: str, generator: Generator,
                              discriminator_state: dict = None) -> None:
    """Write ``generator`` in the reference layout: the plain form, or the
    adversarial form with its ``conditional`` flag when a discriminator
    ``state_dict`` is given."""
    gen_sd = generator_state_dict(generator)
    obj = gen_sd if discriminator_state is None else {
        "generator": gen_sd,
        "discriminator": {k: v.detach().cpu()
                          for k, v in discriminator_state.items()},
        "conditional": generator.encoder is not None,
        "gen_arch": _arch_of(gen_sd)}
    torch.save(obj, path)


def _arch_of(gen_sd) -> str:
    return "transformer" if "decoder.pos" in gen_sd else "lstm"


def load_generator_checkpoint(path: str, config: Config, device="cpu"):
    """Load either checkpoint form → ``(Generator on device,
    discriminator state_dict or None)``.  The keys must match the
    configured geometry exactly, and the checkpoint's conditionality
    ``--conditional-gan``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    disc, conditional, arch = None, None, None
    if isinstance(obj.get("generator"), dict):
        disc = obj.get("discriminator")
        conditional = obj.get("conditional")
        arch = obj.get("gen_arch")
        obj = obj["generator"]
    arch = arch or _arch_of(obj)
    if arch != config.gen_arch:
        raise ValueError(f"{path}: a {arch} generator checkpoint does not "
                         f"match --gen-arch {config.gen_arch}")
    if conditional is None:
        conditional = any(k.startswith("encoder.") for k in obj)
    if bool(conditional) != config.cgan:
        raise ValueError(
            f"{path}: checkpoint conditionality ({bool(conditional)}) does "
            f"not match --conditional-gan {config.conditional_gan}")
    state = {_rename_backbone(k, _FROM_SEQUENTIAL): v for k, v in obj.items()
             if k.startswith(("decoder.", "encoder."))}
    gen = (TransformerGenerator(config, device) if arch == "transformer"
           else Generator(config, device))
    gen.load_state_dict(state, strict=True)
    return gen, disc
