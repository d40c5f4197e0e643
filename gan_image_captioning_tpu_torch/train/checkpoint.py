"""Generator checkpoints in the reference ``state_dict`` layout
(``gan_image_captioning_tpu/train/checkpoint.py:load_generator_checkpoint``).

A checkpoint is a ``torch.save``-d dict with the reference's keys
(``decoder.embed.weight``, ``decoder.lstm.weight_ih_l{k}``,
``decoder.linear.weight`` …): either the generator ``state_dict`` itself
(``pretrained_model.ckpt`` style) or ``{"generator": …, "discriminator":
…}`` (``adv_model.ckpt`` style).  ``src/export_torch.py`` writes both forms
from a JAX checkpoint.
"""

from __future__ import annotations

import os

import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.generator import Generator


def save_generator_checkpoint(path: str, generator: Generator,
                              discriminator_state: dict = None) -> None:
    """Write ``generator`` in the reference layout (the adversarial form
    when a discriminator ``state_dict`` is given)."""
    gen_sd = {k: v.detach().cpu() for k, v in generator.state_dict().items()}
    obj = gen_sd if discriminator_state is None else {
        "generator": gen_sd, "discriminator": discriminator_state}
    torch.save(obj, path)


def load_generator_checkpoint(path: str, config: Config, device="cpu"):
    """Load either checkpoint form → ``(Generator on device,
    discriminator state_dict or None)``.  The decoder keys must match the
    configured geometry exactly; encoder keys (conditional checkpoints)
    are not read."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    disc = None
    if isinstance(obj.get("generator"), dict):
        disc = obj.get("discriminator")
        obj = obj["generator"]
    state = {k: v for k, v in obj.items() if k.startswith("decoder.")}
    gen = Generator(config, device)
    gen.load_state_dict(state, strict=True)
    return gen, disc
