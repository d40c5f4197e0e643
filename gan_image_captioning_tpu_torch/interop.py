"""Weights bridge from the JAX package's generator param tree.

The JAX package keeps generator params in torch layouts already
(``embed [V, E]``, per-layer ``w_ih [4H, In]`` …, ``linear {w [V, H],
b [V]}``), so the bridge only renames: it takes the tree as numpy arrays
(``{"decoder": {...}}`` or the decoder dict itself) and returns the
port's ``state_dict`` in the reference layout, or a loaded
:class:`~gan_image_captioning_tpu_torch.models.generator.Generator`.
Nothing here imports JAX; the caller converts its arrays with
``numpy.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.generator import Generator


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) → reference-layout state_dict."""
    dec = tree["decoder"] if "decoder" in tree else tree
    out = {"decoder.embed.weight": _t(dec["embed"]),
           "decoder.linear.weight": _t(dec["linear"]["w"]),
           "decoder.linear.bias": _t(dec["linear"]["b"])}
    for k, layer in enumerate(dec["lstm"]):
        out[f"decoder.lstm.weight_ih_l{k}"] = _t(layer["w_ih"])
        out[f"decoder.lstm.weight_hh_l{k}"] = _t(layer["w_hh"])
        out[f"decoder.lstm.bias_ih_l{k}"] = _t(layer["b_ih"])
        out[f"decoder.lstm.bias_hh_l{k}"] = _t(layer["b_hh"])
    return out


def generator_from_jax(tree: dict, config: Config, device="cpu") -> Generator:
    """A port :class:`Generator` holding the JAX tree's weights."""
    gen = Generator(config, device)
    gen.load_state_dict(params_from_jax(tree), strict=True)
    return gen
