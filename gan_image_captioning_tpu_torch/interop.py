"""Bridge from the JAX package's parameter trees and training state.

The JAX package keeps its params in torch layouts already (generator
``embed [V, E]``, per-layer ``w_ih [4H, In]`` …, ``linear {w [V, H],
b [V]}``; encoder convs OIHW, ``proj {w [E, 512], b}``, BatchNorm
``scale``/``bias`` with the running statistics in a parallel ``bn_stats``
tree; discriminator ``embeddings.w [Ed, V]``, ``convs[i].w [n, 1, f,
eds]`` …), so the bridge only renames: it takes trees as numpy arrays and
returns the port's ``state_dict``s (the encoder's backbone under
torchvision's names), the loaded modules, a quantized decoder
(:func:`qdec_from_jax`), or a whole
:class:`~gan_image_captioning_tpu_torch.train.state.TrainState`.  The
transformer generator and the transformer and BiLSTM discriminators keep
the JAX trees' own names and layouts (dense ``w [in, out]``, ``linear.w
[V, d]``, ``embeddings.w [Ed, V]``, ``fwd.{k}.w_ih``), so their bridge
(:func:`flatten_jax`) only joins the path into a dotted name.  Nothing
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
    """A numpy leaf as a tensor of its dtype; a bfloat16 leaf (the
    ``ml_dtypes`` type JAX arrays turn into: a ``GIC_BF16_MU`` first
    moment, ``--dtype bfloat16`` running statistics) keeps its bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bn_from_jax(out: dict, name: str, weights: dict, stats: dict) -> None:
    out[f"{name}.weight"] = _t(weights["scale"])
    out[f"{name}.bias"] = _t(weights["bias"])
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def encoder_params_from_jax(enc: dict,
                            prefix: str = "encoder.") -> Dict[str, torch.Tensor]:
    """A JAX ``encoder`` tree (``backbone``, ``proj``, ``head_bn``,
    ``bn_stats``) → the port's :class:`Encoder` ``state_dict``: a ResNet
    backbone under torchvision's names (``num_batches_tracked`` zero), a
    ViT backbone (``patch_embed``, ``cls``, ``pos``, ``blocks``, ``ln_f``)
    under its own tree paths below ``vit.``."""
    bw, bs = enc["backbone"], enc["bn_stats"]["backbone"]
    if "patch_embed" in bw:
        out = flatten_jax(bw, prefix + "vit.")
    else:
        out = _resnet_from_jax(bw, bs, prefix + "resnet.")
    out[prefix + "linear.weight"] = _t(enc["proj"]["w"])
    out[prefix + "linear.bias"] = _t(enc["proj"]["b"])
    _bn_from_jax(out, prefix + "bn", enc["head_bn"], enc["bn_stats"]["head"])
    return out


def _resnet_from_jax(bw: dict, bs: dict, r: str) -> Dict[str, torch.Tensor]:
    out = {r + "conv1.weight": _t(bw["conv1"]["w"])}
    _bn_from_jax(out, r + "bn1", bw["bn1"], bs["bn1"])
    for s in range(1, 5):
        for b, (blk, st) in enumerate(zip(bw[f"layer{s}"], bs[f"layer{s}"])):
            base = f"{r}layer{s}.{b}"
            out[f"{base}.conv1.weight"] = _t(blk["conv1"]["w"])
            out[f"{base}.conv2.weight"] = _t(blk["conv2"]["w"])
            _bn_from_jax(out, f"{base}.bn1", blk["bn1"], st["bn1"])
            _bn_from_jax(out, f"{base}.bn2", blk["bn2"], st["bn2"])
            if "downsample" in blk:
                out[f"{base}.downsample.0.weight"] = _t(blk["downsample"]["w"])
                _bn_from_jax(out, f"{base}.downsample.1", blk["downsample_bn"],
                             st["downsample_bn"])
    return out


def encoder_from_jax(enc: dict, config: Config, device="cpu"):
    """A port :class:`Encoder` holding a JAX ``encoder`` tree's weights
    and running statistics."""
    from gan_image_captioning_tpu_torch.models.encoder import Encoder

    encoder = Encoder(config, device)
    encoder.load_state_dict(encoder_params_from_jax(enc, prefix=""),
                            strict=True)
    return encoder


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) → reference-layout state_dict
    (with the encoder's keys when the tree has an ``encoder``)."""
    dec = tree["decoder"] if "decoder" in tree else tree
    out = {"decoder.embed.weight": _t(dec["embed"]),
           "decoder.linear.weight": _t(dec["linear"]["w"]),
           "decoder.linear.bias": _t(dec["linear"]["b"])}
    for k, layer in enumerate(dec["lstm"]):
        out[f"decoder.lstm.weight_ih_l{k}"] = _t(layer["w_ih"])
        out[f"decoder.lstm.weight_hh_l{k}"] = _t(layer["w_hh"])
        out[f"decoder.lstm.bias_ih_l{k}"] = _t(layer["b_ih"])
        out[f"decoder.lstm.bias_hh_l{k}"] = _t(layer["b_hh"])
    if tree.get("encoder") is not None:
        out.update(encoder_params_from_jax(tree["encoder"]))
    return out


def flatten_jax(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested JAX tree (dicts, lists) → ``{dotted path: tensor}``: the
    ``state_dict`` of the port's transformer modules."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: _t(tree)}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(flatten_jax(v, f"{prefix}{k}."))
    return out


def _transformer_gen_params(tree: dict) -> Dict[str, torch.Tensor]:
    out = flatten_jax({"decoder": tree["decoder"]})
    if tree.get("encoder") is not None:
        out.update(encoder_params_from_jax(tree["encoder"]))
    return out


def transformer_generator_from_jax(tree: dict, config: Config,
                                   device="cpu"):
    """A port ``TransformerGenerator`` holding a JAX transformer
    generator's weights (``{"decoder": …}``, and a conditional one's
    ``encoder``: ResNet-18 or ViT)."""
    from gan_image_captioning_tpu_torch.models.transformer import (
        TransformerGenerator)

    gen = TransformerGenerator(config, device)
    gen.load_state_dict(_transformer_gen_params(tree), strict=True)
    return gen


def transformer_discriminator_from_jax(tree: dict, config: Config,
                                       device="cpu"):
    """A port ``TransformerDiscriminator`` holding a JAX transformer
    discriminator's weights (either variant: they share the tree)."""
    from gan_image_captioning_tpu_torch.models.discriminator_transformer \
        import TransformerDiscriminator

    disc = TransformerDiscriminator(config, device)
    disc.load_state_dict(flatten_jax(tree), strict=True)
    return disc


def bilstm_discriminator_from_jax(tree: dict, config: Config,
                                  device="cpu"):
    """A port ``BiLSTMDiscriminator`` holding a JAX BiLSTM discriminator
    tree (its names are the JAX paths: :func:`flatten_jax`)."""
    from gan_image_captioning_tpu_torch.models.discriminator_bilstm import (
        BiLSTMDiscriminator)

    disc = BiLSTMDiscriminator(config, device)
    disc.load_state_dict(flatten_jax(tree), strict=True)
    return disc


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


def _adam_from_jax(opt_state, rename, module, device):
    """The ``ScaleByAdamState`` of a JAX ``clip → adam`` chain state
    (``opt_state[1][0]``) → the port's ``AdamState`` over ``module``'s
    trainable parameters.  The JAX moments of what the port keeps out of
    its optimizer are dropped: the encoder's running statistics, and a
    frozen backbone's (zero for a ResNet, whose grid the JAX package stops;
    a frozen ViT's are not, since the JAX package differentiates into it,
    which the port does not: ``models/encoder.py``)."""
    from gan_image_captioning_tpu_torch.train.state import (
        AdamState, trainable_parameters)

    adam = opt_state[1][0]
    keys = trainable_parameters(module).keys()
    mu, nu = rename(adam.mu), rename(adam.nu)
    return AdamState(int(np.asarray(adam.count)),
                     {k: mu[k].to(device) for k in keys},
                     {k: nu[k].to(device) for k in keys})


def train_state_from_jax(state, config: Config, device="cpu"):
    """A JAX ``TrainState`` (numpy leaves) → the port's ``TrainState``:
    params (and a conditional generator's running statistics), the three
    Adam states (count and moments, see :func:`_adam_from_jax`), the step
    counters, the temperature and the generator's EMA
    (``ema_gen_params``, under the generator's ``state_dict`` names; None
    when the JAX state has none), so that a port run continues it.  The
    JAX PRNG stream cannot be carried over; the port's generator is seeded
    from the key's bits instead."""
    from gan_image_captioning_tpu_torch.train.state import (TrainState,
                                                            freeze_backbone)

    key = np.asarray(state.rng).astype(np.uint64).reshape(-1)
    seed = int(key[-2]) << 32 | int(key[-1]) if key.size > 1 else int(key[0])
    if config.gen_arch == "transformer":
        gen = transformer_generator_from_jax(state.gen_params, config, device)
        gen_rename = _transformer_gen_params
    else:
        gen = generator_from_jax(state.gen_params, config, device)
        gen_rename = params_from_jax
    freeze_backbone(gen, config)
    if config.disc_arch == "cnn":
        disc = discriminator_from_jax(state.disc_params, config, device)
        disc_rename = disc_params_from_jax
    elif config.disc_arch == "bilstm":
        disc = bilstm_discriminator_from_jax(state.disc_params, config,
                                             device)
        disc_rename = flatten_jax
    else:
        disc = transformer_discriminator_from_jax(state.disc_params, config,
                                                  device)
        disc_rename = flatten_jax
    ema = None
    if state.ema_gen_params is not None:
        sd = gen.state_dict()
        values = gen_rename(state.ema_gen_params)
        ema = {k: values[k].to(device) for k, v in sd.items()
               if v.is_floating_point()}
    return TrainState(
        gen=gen, disc=disc,
        pretrain_opt=_adam_from_jax(state.pretrain_opt_state, gen_rename,
                                    gen, device),
        gen_opt=_adam_from_jax(state.gen_opt_state, gen_rename, gen, device),
        disc_opt=_adam_from_jax(state.disc_opt_state, disc_rename, disc,
                                device),
        generator=torch.Generator().manual_seed(seed),
        pretrain_steps=int(np.asarray(state.pretrain_steps)),
        gen_steps=int(np.asarray(state.gen_steps)),
        disc_steps=int(np.asarray(state.disc_steps)),
        temperature=float(np.asarray(state.temperature)),
        ema_gen=ema)
