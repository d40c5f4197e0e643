"""The serving and training subset of the flag system.

Counterpart of ``gan_image_captioning_tpu/config.py``: the same flag names
and defaults for what the serving path and the MLE / adversarial training
steps read, parsed into a frozen :class:`Config`.  ``--device`` defaults to
``cuda``; :func:`resolve_device` turns it into a ``torch.device`` and
refuses to fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import torch


def _int_list(text):
    """A comma-separated int list, e.g. ``3,4,5`` (the JAX package's
    parser for ``--disc-filter-sizes`` / ``--disc-num-filters``)."""
    if isinstance(text, (list, tuple)):
        return [int(x) for x in text]
    return [int(x) for x in str(text).replace(" ", "").split(",") if x]


def add_model_args(parser):
    """Generator and discriminator flags (the JAX package's
    ``add_model_args``)."""
    g = parser.add_argument_group("model")
    g.add_argument("--gen-hidden-dim", type=int, default=512,
                   help="hidden dimension of generator")
    g.add_argument("--gen-embed-dim", type=int, default=32,
                   help="embedding dimension of generator")
    g.add_argument("--gen-num-layers", type=int, default=1,
                   help="number of layers in generator")
    g.add_argument("--gen-init", type=str, default="uniform",
                   choices=["uniform", "normal"],
                   help="Initialization strategy for generator weights")
    g.add_argument("--conditional-gan", type=int, default=0, choices=[0, 1],
                   help="is the gan conditional?")
    g.add_argument("--gen-arch", type=str, default="lstm",
                   choices=["lstm", "transformer", "gpt2"],
                   help="generator architecture")
    g.add_argument("--disc-embed-dim", type=int, default=64,
                   help="embeddings dimension to use in discriminator")
    g.add_argument("--disc-num-rep", type=int, default=64,
                   help="number of representations to use for CNN "
                        "discriminator")
    g.add_argument("--disc-filter-sizes", type=_int_list, default=[3, 4, 5],
                   help="Layer wise filter sizes to use in discriminator")
    g.add_argument("--disc-num-filters", type=_int_list,
                   default=[300, 300, 300],
                   help="number of filters to use in discriminator per layer")
    g.add_argument("--disc-init", type=str, default="uniform",
                   choices=["uniform", "normal"],
                   help="init strategy for discriminator weights")


def add_training_args(parser):
    """Optimizer and adversarial-training flags (the JAX package's
    ``add_training_args`` and stabilization flags)."""
    g = parser.add_argument_group("training")
    g.add_argument("--pretrain-lr", type=float, default=1e-2,
                   help="learning rate for pretraining generator")
    g.add_argument("--gen-lr", type=float, default=1e-4,
                   help="learning rate for adversarial training of generator")
    g.add_argument("--disc-lr", type=float, default=1e-4,
                   help="learning rate for adversarial training of "
                        "discriminator")
    g.add_argument("--disc-train-freq", type=int, default=1,
                   help="generator steps per discriminator step")
    g.add_argument("--adv-loss-type", type=str, default="standard",
                   choices=["standard", "JS", "KL", "hinge", "tv", "rsgan"],
                   help="Loss function to use for adversarial training")
    g.add_argument("--temperature", type=int, default=100,
                   help="Maximum Gumbel temperature for RelGAN training")
    g.add_argument("--temp-adpt", type=str, default="exp",
                   choices=["no", "lin", "exp", "log", "sigmoid", "quad",
                            "sqrt"],
                   help="Temperature adaption strategy")
    g.add_argument("--clip-norm", type=float, default=5.0,
                   help="Gradient clipping threshold (global norm)")
    g.add_argument("--label-smoothing", type=float, default=0.0,
                   help="one-sided label smoothing for the discriminator's "
                        "real targets")
    g.add_argument("--noisy-labels", type=float, default=0.0,
                   help="probability of flipping real/fake labels for the "
                        "discriminator")
    g.add_argument("--mle-objective", type=str, default="free",
                   choices=["free", "teacher", "scheduled"],
                   help="LSTM pretrain forward: 'free' = free-running sample "
                        "(the reference's objective), 'teacher' = teacher "
                        "forcing; 'scheduled' is not ported yet")
    g.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (only float32 is ported yet)")


def add_data_args(parser):
    """Data flags (the JAX package's ``add_data_args`` and ``--dataset``)."""
    g = parser.add_argument_group("data")
    g.add_argument("--max-seq-len", type=int, default=34,
                   help="maximum sequence length of captions")
    g.add_argument("--dataset", type=str, default="coco",
                   choices=["coco", "synthetic"],
                   help="'synthetic' = the deterministic fixture vocabulary")
    g.add_argument("--vocab-multiple", type=int, default=1,
                   help="round the dataset vocab size up to a multiple of "
                        "this; padded ids are never produced by data and "
                        "decode maps them to <UNK>")


def add_global_args(parser):
    g = parser.add_argument_group("global")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: 'cuda' (default), "
                        "'cuda:N' or 'cpu'")


def add_extension_args(parser):
    """The decode extensions of the JAX package's ``add_tpu_args`` that
    the port has."""
    g = parser.add_argument_group("extensions")
    g.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int4"],
                   help="weight-only quantization of the decode path "
                        "(serve): int8 stores the decoder (embedding, LSTM "
                        "stack, vocab projection) as symmetric "
                        "per-channel int8, int4 as int4 packed two per "
                        "byte (ops/quantize.py); training stays float32")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("GAN captioning (PyTorch port)")
    add_data_args(parser)
    add_model_args(parser)
    add_training_args(parser)
    add_extension_args(parser)
    add_global_args(parser)
    return parser


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen view of the flags (field names and defaults as in the JAX
    package's ``Config``, except the two kernel routes below).

    ``decode_impl`` / ``disc_engine``: ``"kernel"`` / ``"mxu"`` (the
    defaults) call the decode, BPTT and conv wrappers, which launch the
    CUDA kernels on CUDA tensors and run the plain versions on CPU ones;
    ``"plain"`` runs the plain PyTorch versions on any device, to compare
    a step through the kernels with the same step without them."""

    vocab_size: int = -1
    gen_embed_dim: int = 32
    gen_hidden_dim: int = 512
    gen_num_layers: int = 1
    max_seq_len: int = 34
    gen_arch: str = "lstm"
    gen_init: str = "uniform"
    conditional_gan: int = 0
    # discriminator
    disc_arch: str = "cnn"
    disc_embed_dim: int = 64
    disc_num_rep: int = 64
    disc_filter_sizes: Tuple[int, ...] = (3, 4, 5)
    disc_num_filters: Tuple[int, ...] = (300, 300, 300)
    disc_init: str = "uniform"
    # training
    pretrain_lr: float = 1e-2
    gen_lr: float = 1e-4
    disc_lr: float = 1e-4
    disc_train_freq: int = 1
    adv_loss_type: str = "standard"
    temperature: int = 100
    temp_adpt: str = "exp"
    clip_norm: float = 5.0
    label_smoothing: float = 0.0
    noisy_labels: float = 0.0
    mle_objective: str = "free"
    dtype: str = "float32"
    lr_schedule: str = "constant"
    grad_accum: int = 1
    ema_decay: float = 0.0
    quantize: str = "none"
    # kernel routes (see the class docstring)
    decode_impl: str = "kernel"
    disc_engine: str = "mxu"

    @property
    def cgan(self) -> bool:
        return self.conditional_gan == 1

    @property
    def seq_len(self) -> int:
        """Static decode length: captions are wrapped ``<S> … <E>``."""
        return self.max_seq_len + 2

    @property
    def disc_feature_dim(self) -> int:
        """sum(num_filters) — reference ``discriminator.py:16``."""
        return int(sum(self.disc_num_filters))

    @property
    def emb_dim_single(self) -> int:
        """Per-representation embedding width — ``discriminator.py:17``."""
        return self.disc_embed_dim // self.disc_num_rep

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in vars(args).items() if k in fields})


def padded_vocab_size(vocab_size: int, multiple: int) -> int:
    """``--vocab-multiple`` padding (``src/main.py:inject_vocab_size``)."""
    if multiple > 1:
        return ((vocab_size + multiple - 1) // multiple) * multiple
    return vocab_size


def resolve_device(name: str) -> torch.device:
    """``--device`` → ``torch.device``.  A CUDA device that is not there is
    an error: the port never quietly carries on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to "
            "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected 'cuda[:N]' or 'cpu'")
    return device
