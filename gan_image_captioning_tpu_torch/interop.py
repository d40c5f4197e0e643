"""Bridge from the JAX package's parameter trees and training state.

The JAX package keeps its params in torch layouts already (generator
``embed [V, E]``, per-layer ``w_ih [4H, In]`` …, ``linear {w [V, H],
b [V]}``; discriminator ``embeddings.w [Ed, V]``, ``convs[i].w
[n, 1, f, eds]`` …), so the bridge only renames: it takes trees as numpy
arrays and returns the port's ``state_dict``s in the reference layout, the
loaded modules, a quantized decoder (:func:`qdec_from_jax`), or a whole
:class:`~gan_image_captioning_tpu_torch.train.state.TrainState`.  Nothing
here imports JAX; the caller converts its arrays with ``numpy.asarray``
(``jax.tree_util.tree_map(np.asarray, tree)`` keeps the named tuples of a
JAX ``TrainState`` and its optax states, which are read by attribute).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_image_captioning_tpu_torch.config import Config
from gan_image_captioning_tpu_torch.models.discriminator import Discriminator
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


def qdec_from_jax(qdec: dict) -> dict:
    """A JAX quantized decoder (``ops/quantize.py:quantize_lstm_decoder``;
    its ``QTensor``s with numpy ``q`` / ``scale``) → the port's form, the
    same payloads, scales and shapes (int4 must be the row-packed int8
    carrier: torch has no int4 dtype)."""
    from gan_image_captioning_tpu_torch.ops.quantize import QTensor

    def qt(x):
        q = np.asarray(x.q)
        if q.dtype != np.int8:
            raise TypeError(f"quantized payload of dtype {q.dtype}: only "
                            "int8 (or int4 packed into int8) converts")
        return QTensor(_t(q), _t(np.asarray(x.scale, np.float32)))

    return {"embed": qt(qdec["embed"]),
            "lstm_q": [{"w": qt(lq["w"]),
                        "b": _t(np.asarray(lq["b"], np.float32))}
                       for lq in qdec["lstm_q"]],
            "linear": {"w": qt(qdec["linear"]["w"]),
                       "b": _t(np.asarray(qdec["linear"]["b"], np.float32))}}


def disc_params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX CNN discriminator params (numpy leaves) → reference-layout
    state_dict (the mapping of ``models/torch_export.py``)."""
    out = {"embeddings.weight": _t(tree["embeddings"]["w"])}
    for name in ("highway", "feature2out", "out2logits"):
        out[f"{name}.weight"] = _t(tree[name]["w"])
        out[f"{name}.bias"] = _t(tree[name]["b"])
    for i, conv in enumerate(tree["convs"]):
        out[f"convs.{i}.weight"] = _t(conv["w"])
        out[f"convs.{i}.bias"] = _t(conv["b"])
    return out


def discriminator_from_jax(tree: dict, config: Config,
                           device="cpu") -> Discriminator:
    """A port :class:`Discriminator` holding the JAX tree's weights."""
    disc = Discriminator(config, device)
    disc.load_state_dict(disc_params_from_jax(tree), strict=True)
    return disc


def _adam_from_jax(opt_state, rename, device):
    """The ``ScaleByAdamState`` of a JAX ``clip → adam`` chain state
    (``opt_state[1][0]``) → the port's ``AdamState``."""
    from gan_image_captioning_tpu_torch.train.state import AdamState

    adam = opt_state[1][0]
    return AdamState(int(np.asarray(adam.count)),
                     {k: v.to(device) for k, v in rename(adam.mu).items()},
                     {k: v.to(device) for k, v in rename(adam.nu).items()})


def train_state_from_jax(state, config: Config, device="cpu"):
    """A JAX ``TrainState`` (numpy leaves) → the port's ``TrainState``:
    params, the three Adam states (count and moments), the step counters
    and the temperature, so that a port run continues it.  The JAX PRNG
    stream cannot be carried over; the port's generator is seeded from the
    key's bits instead."""
    from gan_image_captioning_tpu_torch.train.state import TrainState

    key = np.asarray(state.rng).astype(np.uint64).reshape(-1)
    seed = int(key[-2]) << 32 | int(key[-1]) if key.size > 1 else int(key[0])
    return TrainState(
        gen=generator_from_jax(state.gen_params, config, device),
        disc=discriminator_from_jax(state.disc_params, config, device),
        pretrain_opt=_adam_from_jax(state.pretrain_opt_state,
                                    params_from_jax, device),
        gen_opt=_adam_from_jax(state.gen_opt_state, params_from_jax, device),
        disc_opt=_adam_from_jax(state.disc_opt_state, disc_params_from_jax,
                                device),
        generator=torch.Generator().manual_seed(seed),
        pretrain_steps=int(np.asarray(state.pretrain_steps)),
        gen_steps=int(np.asarray(state.gen_steps)),
        disc_steps=int(np.asarray(state.disc_steps)),
        temperature=float(np.asarray(state.temperature)))
